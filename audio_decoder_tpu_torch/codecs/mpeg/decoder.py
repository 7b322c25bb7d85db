"""Batched MPEG audio decode orchestration, routed by layer.

Layer III: the host front-end (the C++ ``mp3fe`` library, native.py)
walks every blob once and emits the raw main_data bytes plus per-lane
side metadata; the entropy decode and DSP then run as one
``dsp.mp3_decode_fused`` call per (channels, joint-stereo,
granules-per-frame) group on the requested device.  Granule counts and
main_data widths are padded to buckets.

The host-Huffman route (``decode_group_hosthuff``): mp3fe's
``analyze_batch`` runs the whole Layer III bitstream decode, Huffman
included, on the host into dense quantized spectra, and one
``dsp.mp3_dsp_tail`` call per (channels, joint-stereo) group turns them
into PCM on the device (``analyze_assets``/``decode_analyses`` do the same
through the Python front-end).

Layers I/II: the host fixed-width walk (``layer12.analyze_l1``/
``analyze_l2``) emits dense codes, classes and scalefactor indices; one
``layer12.l12_synthesize`` call per channel count requantizes them and
runs the synthesis on the device.

Streams: ``Mp3Stream`` (Layer III) and ``L12Stream`` (Layers I/II) decode
one long file in fixed windows through the same device programs, with
bounded device memory; ``mpeg_stream`` routes by layer and
``gapless_bounds`` reads the LAME tag's encoder delay and padding.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING

import numpy as np
import torch

from ...core import errors as E
from ...core.batch import AudioBatch, host_audio_seconds
from ...utils.trace import TRACE, span, to_device, to_host
from . import frontend
from . import layer12 as L12
from . import native
from .dsp import compact_lane_wire, mp3_decode_fused, mp3_dsp_tail

if TYPE_CHECKING:  # pragma: no cover
    from ...io.assets import Asset


def _bucket(n: int, minimum: int = 8) -> int:
    """Round n up to a power of two OR 3/4 of one (two sizes per octave);
    the 3/4 step caps padding waste at ~1/3."""
    size = minimum
    while size < n:
        size *= 2
    if size > minimum and n <= size // 4 * 3:
        return size // 4 * 3
    return size


def _error_batch(names, codes, device) -> AudioBatch:
    n = len(names)

    def z():
        return torch.zeros((n,), dtype=torch.int32, device=device)

    return AudioBatch(
        data=torch.zeros((n, 1), dtype=torch.float32, device=device),
        sample_rate=z(),
        num_channels=z(),
        bits_per_sample=z(),
        valid_frames=z(),
        err=_meta(codes, device),
        names=tuple(names),
        formats=("mp3",) * n,
    )


def _rate_idx_arr(sample_rate: np.ndarray) -> np.ndarray:
    from . import tables as T

    out = np.zeros(len(sample_rate), np.int32)
    for i, sr in enumerate(np.asarray(sample_rate)):
        out[i] = T.RATE_IDX.get(int(sr), 0)
    return out


def _resolve(device) -> torch.device:
    """``device`` as a torch.device; None means the card."""
    from ..registry import resolve_device

    return resolve_device("cuda" if device is None else device)


def _meta(vals, device) -> torch.Tensor:
    return to_device(np.asarray(vals, np.int32), device)


def analyze_assets(assets: "list[Asset]"):
    """Host front-end over a list of assets → (analyses, failures).

    analyses: list of (local_index, Mp3Analysis); failures: (idx, errcode).
    """
    analyses = []
    failures = []
    for i, a in enumerate(assets):
        try:
            analyses.append((i, frontend.analyze(a.data)))
        except E.DecodeError as e:
            failures.append((i, e.code))
        except Exception:
            failures.append((i, E.ERR_INVALID))
    return analyses, failures


def _tail_batch(is_q, exp_b, st, cfg, sample_rate, channels, n_granules, err,
                names, *, ch: int, joint: bool, device) -> AudioBatch:
    """Padded host arrays of one (channels, joint) group → one
    ``mp3_dsp_tail`` call on ``device`` (one copy per array) → its batch."""
    B, G = is_q.shape[:2]

    def put(a, shape):
        return to_device(a.reshape(shape), device)

    pcm = mp3_dsp_tail(
        put(is_q, (B, G * ch, 576)),
        put(exp_b, (B, G * ch * 61)),
        None if st is None else put(st, (B, G * 576)),
        put(cfg, (B, G * ch)),
        _meta(_rate_idx_arr(sample_rate), device),
        channels=ch,
        joint_stereo=joint,
    )
    return AudioBatch(
        data=pcm, channels=ch,
        sample_rate=_meta(sample_rate, device),
        num_channels=_meta(channels, device),
        bits_per_sample=_meta(np.full((B,), 16), device),  # MP3 nominal depth
        valid_frames=_meta(np.asarray(n_granules) * 576, device),
        err=_meta(err, device),
        names=tuple(names),
        formats=("mp3",) * B,
    )


def decode_analyses(
    idxs: list[int], ans: list["frontend.Mp3Analysis"], *, device=None,
) -> tuple[list[int], AudioBatch]:
    """Run one uniform (channels, joint) group through the DSP tail on
    ``device`` (None: the card)."""
    dev = _resolve(device)
    ch = ans[0].channels
    joint = any(a.joint_stereo for a in ans)
    B = len(ans)
    G = _bucket(max(a.n_granules for a in ans))
    is_q = np.zeros((B, G, ch, 576), np.int16)
    exp_b = np.zeros((B, G, ch, 61), np.int16)
    st = None
    if ch == 2 and joint:
        st = np.zeros((B, G, 576), np.int8)
    cfg = np.zeros((B, G, ch), np.int8)
    for b, a in enumerate(ans):
        g = a.n_granules
        is_q[b, :g] = a.is_q
        exp_b[b, :g] = a.exp_b
        if st is not None and a.st_mode is not None:
            st[b, :g] = a.st_mode
        cfg[b, :g] = a.blockcfg
    batch = _tail_batch(
        is_q, exp_b, st, cfg, [a.sample_rate for a in ans],
        [a.channels for a in ans], [a.n_granules for a in ans], np.zeros(B),
        [str(i) for i in idxs], ch=ch, joint=joint, device=dev)
    return idxs, batch


def _decode_group_native(
    assets: "list[Asset]", device,
) -> list[tuple[list[int], AudioBatch]]:
    """Native-front-end path: threaded C++ bitstream analysis straight into
    the padded arrays, one DSP-tail call per (channels, joint) group."""
    probes = [native.probe(a.data) for a in assets]

    pieces: list[tuple[list[int], AudioBatch]] = []
    failed = [i for i, p in enumerate(probes) if p["err"] != 0]
    if failed:
        pieces.append(
            (failed, _error_batch([assets[i].name for i in failed],
                                  [probes[i]["err"] for i in failed], device))
        )

    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(probes):
        if p["err"] == 0:
            groups.setdefault((p["channels"], p["joint"]), []).append(i)

    for (ch, joint), idxs in groups.items():
        g_cap = _bucket(max(probes[i]["n_granules"] for i in idxs))
        with span("mp3.hosthuff_analyze"):
            r = native.analyze_batch([assets[i].data for i in idxs], g_cap,
                                     ch, joint)
        batch = _tail_batch(
            r["is_q"], r["exp_b"], r["st"], r["cfg"], r["sample_rate"],
            r["channels"], r["n_granules"], r["err"],
            [assets[i].name for i in idxs], ch=ch, joint=joint, device=device)
        pieces.append((idxs, batch))
    return pieces


def _n_big(big, valid) -> int:
    """The scan's big-values pair cap for a lane set: the largest
    big_values of a valid lane rounded up to 32 (pairs beyond 288 still
    consume bits through the count1 cursor, so it follows the true max,
    <= 511, not the 576-line cap), 32 for no valid lane."""
    bvs = np.asarray(big).reshape(-1)[np.asarray(valid).reshape(-1) > 0]
    return 32 if bvs.size == 0 else min(512, int(-(-int(bvs.max()) // 32) * 32))


def _plan_buckets(big, valid, n_big: int):
    """Pick a multi-bucket lane split for the Huffman scan.

    big_values is heavily skewed (sparse granules put nearly everything in
    the count1 region; MS side channels are nearly empty), so running
    every lane for the max lane's pair count wastes most steps.  Sort
    lanes by descending big_values and partition into up to 3 buckets at
    pair caps chosen by a cost model (pairs + half-weight count1);
    bucket boundaries are rounded up to N/8 quanta.  Count1 bounds are
    per bucket: the sort order means a dense bucket's count1 region is
    bounded by its LAST lane.

    Returns (perm, buckets): perm None → no permutation needed (single
    bucket); buckets = ((lane_count, n_big, n_c1), ...) in sorted-lane
    order, counts summing to N, empty buckets dropped."""
    v = np.asarray(valid).reshape(-1) > 0
    bv = np.where(v, np.asarray(big).reshape(-1).astype(np.int64), 0)
    N = bv.size
    order = np.argsort(-bv, kind="stable").astype(np.int32)
    sbv = bv[order]
    # quads actually placeable per lane (invalid lanes place none)
    squads = np.where(v[order], (576 - 2 * sbv).clip(0) // 4 + 1, 0).clip(0, 144)
    quantum = max(32, -(-N // 8))

    def r32(x, cap):
        return int(min(cap, max(32, -(-int(x) // 32) * 32)))

    def eval_plan(caps_desc):
        """caps_desc: descending pair caps, first = n_big (dense)."""
        ks = [int(np.count_nonzero(sbv > cap)) for cap in caps_desc[1:]]
        bounds = []
        prev = 0
        for k in ks:
            kq = min(N, -(-k // quantum) * quantum) if k else 0
            kq = max(kq, prev)
            bounds.append(kq)
            prev = kq
        bounds.append(N)
        buckets = []
        cost = 0.0
        prev = 0
        for cap, b in zip(caps_desc, bounds):
            cnt = b - prev
            if cnt > 0:
                q = r32(squads[prev:b].max(), 144)
                buckets.append((cnt, int(cap), q))
                cost += cnt * (cap + 0.5 * q)
            prev = b
        return cost, tuple(buckets)

    single_cost, single = eval_plan([n_big])
    best_cost, best = single_cost, single
    caps = [c for c in (32, 96, 160, 224) if c < n_big]
    for r in (1, 2):
        for combo in itertools.combinations(caps, r):
            cost, plan = eval_plan([n_big] + sorted(combo, reverse=True))
            if cost < best_cost:
                best_cost, best = cost, plan

    if best == single or best_cost > 0.85 * single_cost:
        return None, single
    if len(best) == 1:  # every lane fits one smaller cap: no perm needed
        return None, best
    return order, best


def fused_wire_args(r: dict, rate_idx, device) -> list:
    """Packed lane dict (native lanes layout) → the positional tensors of
    ``dsp.mp3_decode_fused`` (sans perm) on ``device``, compacted via
    ``compact_lane_wire``.  A lane whose exponents can't ship exactly
    (impossible for spec-legal streams) is dropped to the invalid path;
    its frame decodes silent, like other lane errors."""
    B, G, ch = r["start"].shape
    L = G * ch
    end_rel, lim_rel, exp_base, exp_d, ok = compact_lane_wire(
        r["start"], r["end"], r["limit"], r["exp_b"], r["cfg"], rate_idx
    )
    valid = np.where(ok, np.asarray(r["valid"]), 0)

    def put(a, shape):
        return to_device(np.ascontiguousarray(np.asarray(a).reshape(shape)),
                         device)

    return [
        put(r["main"], r["main"].shape),
        put(r["start"], (B, L)),
        # uint16 offsets travel as int32: torch's uint16 supports few ops
        put(end_rel.astype(np.int32), (B, L)),
        put(lim_rel.astype(np.int32), (B, L)),
        put(r["big"], (B, L)),
        put(r["r1"], (B, L)),
        put(r["r2"], (B, L)),
        put(r["tsel"], (B, L * 3)),
        put(r["c1sel"], (B, L)),
        put(valid, (B, L)),
        put(exp_base, (B, L)),
        put(exp_d, (B, L * 61)),
        put(r["cfg"], (B, L)),
        put(r["stflags"], (B, G)),
        put(r["sfr"], (B, G * 61)),
        put(np.asarray(rate_idx, np.int32), (B,)),
    ]


def _decode_group_fused(
    assets: "list[Asset]", sess: "native.Mp3Session", sess_idx: list[int],
    device,
) -> list[tuple[list[int], AudioBatch]]:
    """On-device-Huffman path: the session emits raw main_data + lane
    metadata from its stored frame tables; the entropy decode + DSP run
    as one ``mp3_decode_fused`` call per (channels, joint, gpf) group."""
    probes = [sess.infos[i] for i in sess_idx]

    pieces: list[tuple[list[int], AudioBatch]] = []
    failed = [i for i, p in enumerate(probes) if p["err"] != 0]
    if failed:
        pieces.append(
            (failed, _error_batch([assets[i].name for i in failed],
                                  [probes[i]["err"] for i in failed], device))
        )

    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(probes):
        if p["err"] == 0:
            gpf = 2 if p["sample_rate"] >= 32000 else 1  # MPEG-1 vs LSF
            groups.setdefault((p["channels"], bool(p["joint"]), gpf), []).append(i)

    for (ch, joint, gpf), idxs in groups.items():
        B = len(idxs)
        g_cap = _bucket(max(probes[i]["n_granules"] for i in idxs))
        m_cap = _bucket(max(probes[i]["main_bytes"] for i in idxs), 1024)
        with span("mp3.wire"):
            r = sess.lanes_batch([sess_idx[i] for i in idxs], g_cap, m_cap, ch)
            n_big = _n_big(r["big"], r["valid"])
            perm, buckets = _plan_buckets(
                r["big"].reshape(-1), r["valid"].reshape(-1), n_big
            )
            wire = fused_wire_args(r, _rate_idx_arr(r["sample_rate"]), device)
            wire.append(None if perm is None else to_device(perm, device))
            meta = dict(
                sample_rate=_meta(r["sample_rate"], device),
                num_channels=_meta(r["channels"], device),
                bits_per_sample=_meta(np.full((B,), 16), device),  # nominal
                valid_frames=_meta(r["n_granules"] * 576, device),
                err=_meta(r["err"], device),
            )
        pcm = mp3_decode_fused(
            *wire,
            channels=ch,
            joint_stereo=joint,
            granules_per_frame=gpf,
            buckets=buckets,
        )
        batch = AudioBatch(
            data=pcm, channels=ch, **meta,
            names=tuple(assets[i].name for i in idxs),
            formats=("mp3",) * B,
        )
        pieces.append((idxs, batch))
        TRACE.add("decode.mp3", host_audio_seconds(r["n_granules"] * 576,
                                                   r["sample_rate"]))
    return pieces


def pack_layer12(analyses: list, device) -> tuple:
    """One channel count's ``layer12.L12Analysis`` list → the (codes, cls,
    sf_idx) tensors of ``l12_synthesize`` on ``device``, frames padded to
    a ``_bucket`` (silent class 0, scalefactor index 63)."""
    a0 = analyses[0]
    B, ch, steps = len(analyses), a0.channels, a0.steps_per_frame
    F = _bucket(max(a.n_frames for a in analyses))
    codes = np.zeros((B, F, ch, 32, steps), np.int32)
    cls = np.zeros((B, F, ch, 32), np.int8)
    sf_idx = np.full((B, F, ch, 32, 3), 63, np.int8)
    for b, a in enumerate(analyses):
        codes[b, : a.n_frames] = a.codes
        cls[b, : a.n_frames] = a.cls
        sf_idx[b, : a.n_frames] = a.sf_idx
    return tuple(to_device(x, device) for x in (codes, cls, sf_idx))


def _decode_group_layer12(
    assets: "list[Asset]", layer: int, device,
) -> list[tuple[list[int], AudioBatch]]:
    """Layer I/II path: host fixed-width parse → requantize + the shared
    polyphase synthesis on ``device`` (layer12.py), one call per channel
    count.  A file's ``DecodeError`` gives its code; any other exception
    gives ``ERR_INVALID``."""
    analyze = L12.analyze_l1 if layer == 1 else L12.analyze_l2
    analyses: list = []
    failures: list = []
    with span("l12.analyze"):
        for i, a in enumerate(assets):
            try:
                analyses.append((i, analyze(a.data)))
            except E.DecodeError as e:
                failures.append((i, e.code))
            except Exception:
                failures.append((i, E.ERR_INVALID))

    pieces: list[tuple[list[int], AudioBatch]] = []
    if failures:
        idxs = [i for i, _ in failures]
        pieces.append(
            (idxs, _error_batch([assets[i].name for i in idxs],
                                [c for _, c in failures], device))
        )

    groups: dict[int, list] = {}
    for i, an in analyses:
        groups.setdefault(an.channels, []).append((i, an))
    for ch, items in groups.items():
        idxs = [i for i, _ in items]
        ans = [a for _, a in items]
        B = len(ans)
        steps = ans[0].steps_per_frame
        pcm = L12.l12_synthesize(*pack_layer12(ans, device), channels=ch,
                                 steps=steps)
        rates = [a.sample_rate for a in ans]
        frames = [a.n_frames * steps * 32 for a in ans]
        batch = AudioBatch(
            data=pcm, channels=ch,
            sample_rate=_meta(rates, device),
            num_channels=_meta([a.channels for a in ans], device),
            bits_per_sample=_meta(np.full((B,), 16), device),
            valid_frames=_meta(frames, device),
            err=_meta(np.zeros((B,)), device),
            names=tuple(assets[i].name for i in idxs),
            formats=(f"mp{layer}",) * B,
        )
        pieces.append((idxs, batch))
        TRACE.add("decode.mp3", host_audio_seconds(frames, rates))
    return pieces


def decode_group(assets: "list[Asset]", *, device) -> list[tuple[list[int], AudioBatch]]:
    """Decode a group of MPEG-audio assets → (local_indices, AudioBatch)
    pieces on ``device``.

    Every blob is frame-walked once by an ``Mp3Session``, which routes by
    the layer of the first valid frame and serves the Layer III grouping
    probes and lane emission from its stored frame tables.  Layers I/II
    take the fixed-width subband path; Layer III (or undetected: the
    fused path reports its errors) the fused on-device-Huffman path.
    Spans: ``mp3.walk`` (the session's walk), then per Layer III group
    ``mp3.wire`` and the device stages of ``dsp.mp3_decode_fused``; each
    piece's decoded audio-seconds go to ``decode.mp3``."""
    with span("mp3.walk"):
        sess = native.Mp3Session([a.data for a in assets])
    with sess:
        by_layer: dict[int, list[int]] = {}
        for i, layer in enumerate(sess.layers):
            by_layer.setdefault(layer, []).append(i)
        pieces: list[tuple[list[int], AudioBatch]] = []
        for layer, idxs in by_layer.items():
            sub = [assets[i] for i in idxs]
            if layer in (1, 2):
                sub_pieces = _decode_group_layer12(sub, layer, device)
            else:
                sub_pieces = _decode_group_fused(sub, sess, idxs, device)
            for local, batch in sub_pieces:
                pieces.append(([idxs[j] for j in local], batch))
        return pieces


def decode_group_hosthuff(
    assets: "list[Asset]", *, device=None,
) -> list[tuple[list[int], AudioBatch]]:
    """Host-Huffman decode path on ``device`` (None: the card): mp3fe's
    threaded C++ analysis, Huffman included, then the DSP tail.  Files are
    grouped by their probed (channels, joint-stereo); a file the probe
    rejects becomes an error piece with its code.  Without mp3fe it raises
    ``BuildError`` (there is no pure-Python fallback)."""
    return _decode_group_native(assets, _resolve(device))


class Mp3Stream:
    """Chunked single-file Layer III decode on ``device``: bounded device
    memory, one static plan.

    The batch path materializes a whole file's PCM in one call whose
    shapes scale with file length — fine for asset folders, wrong for a
    two-hour stream (the granule tensors grow without bound).  This
    decoder walks the file ONCE on the host (mp3fe's ``lanes_batch``, the
    emission the batch path uses), then decodes fixed-size granule windows
    through the same fused device program, so one lane plan serves any
    file length and device memory is O(granules_per_chunk).

    Chunk boundaries are made exact with a 2-granule warm-up re-decoded
    at the head of every chunk (and discarded):

      * the bit reservoir needs no decoded state at all — each lane's
        absolute bit window into the concatenated main_data already
        resolves ``main_data_begin``, the chunk just ships the byte
        slice its windows cover;
      * hybrid-IMDCT overlap-add is one granule of memory, and the
        overlap TAIL a granule hands forward is a pure function of that
        granule's own spectra — so warm-up granule #2 hands the first
        kept granule its exact overlap;
      * the polyphase synthesis FIR window spans 16 V-steps < the 18
        steps one granule pushes, so the kept region's history lies
        entirely inside correctly-overlapped warm-up output.

    Yields float32 ``[samples, channels]`` host chunks; concatenated
    output equals the one-shot batch decode on the same device.  The
    entropy scan (K1) and the synthesis (K2) run as the CUDA kernels on
    a CUDA device and as their plain twins on the CPU."""

    WARMUP = 2

    def __init__(self, data: bytes, granules_per_chunk: int = 512, *,
                 device="cuda"):
        from ..registry import resolve_device

        self.device = resolve_device(device)
        if frontend.probe_layer(data) != 3:
            raise E.UnsupportedFormatError(
                "Mp3Stream decodes Layer III; use decode_group for I/II")
        if granules_per_chunk < 8:
            raise ValueError("granules_per_chunk must be >= 8")
        self.gpc = int(granules_per_chunk)
        p = native.probe(data)
        E.raise_for_code(int(p["err"]), "mp3 stream probe")
        ch = int(p["channels"])
        g_tot = int(p["n_granules"])
        m_cap = -(-int(p["main_bytes"]) // 32) * 32
        self._r = native.lanes_batch([data], max(g_tot, 1), m_cap, ch)
        self._joint = bool(p["joint"])
        E.raise_for_code(int(self._r["err"][0]), "mp3 stream")
        self.channels = ch
        self.n_granules = g_tot
        self.sample_rate = int(self._r["sample_rate"][0])
        self.total_samples = g_tot * 576
        self._gpf = 2 if self.sample_rate >= 32000 else 1
        self._rate_idx = _rate_idx_arr(self._r["sample_rate"])
        # One static plan for the WHOLE stream: every chunk shares one
        # (g_cap, m_cap, n_big, bucket) signature (the batch path plans
        # per batch instead — its lanes all run in one call anyway).
        self._n_big = _n_big(self._r["big"], self._r["valid"])
        g_cap = self.gpc + self.WARMUP
        self._m_cap = _bucket(self._widest_window(g_cap), 1024)
        self._buckets = ((g_cap * ch, self._n_big, 144),)

    def _widest_window(self, g_cap: int) -> int:
        """The largest ``_byte_window`` byte count of any ``g_cap`` granules
        in a row: a chunk after a seek may start at any granule, and every
        chunk's granules lie inside such a run.  Sliding minimum and
        maximum by blocks of ``g_cap`` (van Herk), O(granules)."""
        r = self._r
        g = self.n_granules
        L = min(g_cap, g)
        if L == 0:
            return 64
        # per granule, over its channels' active lanes
        act = r["valid"][0, :g] > 0
        lo = np.where(act, r["start"][0, :g], np.iinfo(np.int64).max).min(1)
        hi = np.where(act, np.maximum(r["end"][0, :g], r["limit"][0, :g]),
                      -1).max(1)

        def sliding(x, fn, fill):
            pad = np.full(-(-g // L) * L, fill, np.int64)
            pad[:g] = x
            blocks = pad.reshape(-1, L)
            head = fn.accumulate(blocks, axis=1).ravel()
            tail = fn.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].ravel()
            return fn(tail[: g - L + 1], head[L - 1: g])

        bit_lo = sliding(lo, np.minimum, np.iinfo(np.int64).max)
        bit_hi = sliding(hi, np.maximum, -1)
        live = bit_hi >= 0
        n = bit_hi[live] // 8 + 1 - (bit_lo[live] // 8) // 32 * 32 + 64
        return int(max(64, n.max(initial=0)))

    def _byte_window(self, lo: int, hi: int) -> tuple[int, int]:
        """(byte_lo, byte_count) of main_data covering granules [lo, hi)
        — every reservoir reach-back and 64 bytes of slack included."""
        r = self._r
        act = r["valid"][0, lo:hi] > 0
        if not act.any():
            return 0, 64
        bit_lo = int(r["start"][0, lo:hi][act].min())
        bit_hi = int(max(r["end"][0, lo:hi][act].max(),
                         r["limit"][0, lo:hi][act].max()))
        byte_lo = (bit_lo // 8) // 32 * 32
        return byte_lo, bit_hi // 8 + 1 - byte_lo + 64

    def chunk_wire(self, lo: int, hi: int) -> dict:
        """The packed lane dict of granules [lo, hi), padded to the
        stream's ``gpc + WARMUP`` granules, with the bit windows rebased
        onto the chunk's ``[1, m_cap]`` main_data byte slice."""
        r = self._r
        g_cap = self.gpc + self.WARMUP
        g_n = hi - lo
        sl = {}
        for k in ("start", "end", "limit", "big", "r1", "r2", "tsel",
                  "c1sel", "valid", "exp_b", "cfg", "stflags", "sfr"):
            sl[k] = np.zeros((1, g_cap) + r[k].shape[2:], r[k].dtype)
            sl[k][0, :g_n] = r[k][0, lo:hi]
        # rebase the bit windows onto the chunk's main_data byte slice:
        # the reservoir reaches backward only through these windows, so
        # covering [min start, max limit/end) bytes is sufficient by
        # construction
        act = sl["valid"][0, :g_n] > 0
        for k in ("start", "end", "limit"):  # invalid lanes keep absolute
            sl[k][0, :g_n][~act] = 0         # offsets — zero, like padding
        byte_lo, need = self._byte_window(lo, hi)
        if need > self._m_cap:
            raise ValueError(
                f"granules [{lo}, {hi}) span {need} main_data bytes, more "
                f"than the stream's {self._m_cap}")
        main = np.zeros((1, self._m_cap), np.uint8)
        avail = min(self._m_cap, r["main"].shape[1] - byte_lo)
        main[0, :avail] = r["main"][0, byte_lo : byte_lo + avail]
        for k in ("start", "end", "limit"):
            sl[k][0, :g_n][act] -= byte_lo * 8
        return dict(sl, main=main)

    def _chunk_pcm(self, lo: int, hi: int) -> np.ndarray:
        """Decode granules [lo, hi) into a host [g_cap*576, C] array."""
        pcm = mp3_decode_fused(
            *fused_wire_args(self.chunk_wire(lo, hi), self._rate_idx,
                             self.device),
            None,
            channels=self.channels,
            joint_stereo=self._joint,
            granules_per_frame=self._gpf,
            buckets=self._buckets,
        )
        # the decode emits flat interleaved [B, S*C]; host reshape is free
        return to_host(pcm[0]).reshape(-1, self.channels)

    def chunks(self, start_sample: int = 0):
        """Yield float32 [samples, channels] host arrays in stream order.

        `start_sample` seeks: output begins exactly at that sample of the
        one-shot decode (concatenated chunks == ``oneshot[start_sample:]``
        bit-identically).  Seeking costs nothing extra — the 2-granule
        warm-up that makes every chunk boundary exact also makes any
        granule a valid entry point (the reservoir is resolved through
        absolute byte windows, not decoded state)."""
        if not 0 <= start_sample <= self.total_samples:
            raise ValueError(
                f"start_sample {start_sample} outside [0, {self.total_samples}]")
        g0 = start_sample // 576
        trim = start_sample - g0 * 576
        for a in range(g0, self.n_granules, self.gpc):
            lo = max(a - self.WARMUP, 0)
            hi = min(a + self.gpc, self.n_granules)
            pcm = self._chunk_pcm(lo, hi)
            keep = a - lo
            out = pcm[keep * 576 : (keep + hi - a) * 576, : self.channels]
            if trim:
                out, trim = out[trim:], 0
            yield out

    def __iter__(self):
        return self.chunks()


class L12Stream:
    """Chunked single-file Layer I/II decode on ``device``.

    Layers I/II have NO bit reservoir — every frame's payload is
    self-contained — so unlike Layer III the host analysis can also be
    O(chunk): __init__ walks the sync headers once (positions only), and
    each chunk re-parses just the byte slice its frames occupy.  The only
    cross-chunk state is the polyphase synthesis FIR history (16
    V-steps); re-decoding ceil(16 / steps_per_frame) warm-up frames at
    each chunk head — 1 frame for Layer II (36 steps), 2 for Layer I
    (12) — reproduces it exactly, so concatenated chunks equal the
    one-shot decode.  The synthesis runs as the K2 kernel on a CUDA
    device."""

    def __init__(self, data: bytes, layer: int | None = None,
                 frames_per_chunk: int = 128, *, device="cuda"):
        from ..registry import resolve_device

        self.device = resolve_device(device)
        if layer is None:
            layer = frontend.probe_layer(data)
        if layer not in (1, 2):
            raise E.UnsupportedFormatError(
                f"L12Stream decodes Layers I/II (probed layer {layer})")
        if frames_per_chunk < 2:
            raise ValueError("frames_per_chunk must be >= 2")
        code = 3 if layer == 1 else 2  # header layer code
        frames = [(p, h) for p, h in frontend.find_frames(data)
                  if h["layer"] == code]
        if not frames:
            raise E.InvalidDataError(f"no Layer {'I' * layer} frames")
        h0 = frames[0][1]
        # same consistency filter as analyze_l1/l2 so framing matches
        self._frames = [
            (p, h) for p, h in frames
            if h["sr"] == h0["sr"] and h["channels"] == h0["channels"]
            and h["version"] == h0["version"]
        ]
        self._blob = data
        self._analyze = L12.analyze_l1 if layer == 1 else L12.analyze_l2
        self.layer = layer
        self.fpc = int(frames_per_chunk)
        self.channels = h0["channels"]
        self.sample_rate = h0["sr"]
        self.spf = 12 if layer == 1 else 36  # V-steps per frame
        #: the synthesis FIR window spans 16 V-steps of history
        self.WARMUP = -(-16 // self.spf)
        self.n_frames = len(self._frames)
        self.total_samples = self.n_frames * self.spf * 32

    def chunk_arrays(self, lo: int, hi: int) -> tuple:
        """Frames [lo, hi) as l12_synthesize's host (codes, cls, sf_idx),
        padded to the stream's ``fpc + WARMUP`` frames: the host walk
        re-parses just the byte slice those frames occupy."""
        F_cap = self.fpc + self.WARMUP
        ch = self.channels
        sub = self._frames[lo:hi]
        b0 = sub[0][0]
        b1 = sub[-1][0] + sub[-1][1]["frame_len"]
        with span("l12.analyze"):
            an = self._analyze(
                self._blob[b0:b1], frames=[(p - b0, h) for p, h in sub])
        n = hi - lo
        codes = np.zeros((1, F_cap, ch, 32, self.spf), np.int32)
        cls = np.zeros((1, F_cap, ch, 32), np.int8)
        sf_idx = np.full((1, F_cap, ch, 32, 3), 63, np.int8)
        codes[0, :n] = an.codes
        cls[0, :n] = an.cls
        sf_idx[0, :n] = an.sf_idx
        return codes, cls, sf_idx

    def chunks(self, start_sample: int = 0):
        """Yield float32 [samples, channels] host chunks; `start_sample`
        seeks (output == one-shot ``pcm[start_sample:]`` bit-identically)."""
        if not 0 <= start_sample <= self.total_samples:
            raise ValueError(
                f"start_sample {start_sample} outside [0, {self.total_samples}]")
        spfr = self.spf * 32  # samples per frame
        f0 = start_sample // spfr
        trim = start_sample - f0 * spfr
        ch = self.channels
        for a in range(f0, self.n_frames, self.fpc):
            lo = max(a - self.WARMUP, 0)
            hi = min(a + self.fpc, self.n_frames)
            pcm = to_host(L12.l12_synthesize(
                *(to_device(x, self.device) for x in self.chunk_arrays(lo, hi)),
                channels=ch, steps=self.spf,
            )[0]).reshape(-1, ch)  # flat interleaved
            keep = a - lo
            out = pcm[keep * spfr : (keep + hi - a) * spfr, :ch]
            if trim:
                out, trim = out[trim:], 0
            yield out

    def __iter__(self):
        return self.chunks()


def mpeg_stream(data: bytes, *, granules_per_chunk: int = 512,
                frames_per_chunk: int = 128, device="cuda"):
    """Streaming decoder for any MPEG audio layer on ``device``: probes
    the first valid frame and returns an Mp3Stream (Layer III) or
    L12Stream (I/II).  Both yield float32 [samples, channels] chunks whose
    concatenation equals the one-shot decode, and both seek via
    ``.chunks(start_sample=N)``."""
    layer = frontend.probe_layer(data)
    if layer == 3:
        return Mp3Stream(data, granules_per_chunk=granules_per_chunk,
                         device=device)
    if layer in (1, 2):
        return L12Stream(data, layer=layer, frames_per_chunk=frames_per_chunk,
                         device=device)
    raise E.InvalidDataError("no MPEG audio frames found")


#: standard MDCT + synthesis filterbank decoder delay (samples): the
#: first 529 output samples of any conformant decoder are filter warm-up
DECODER_DELAY = 529


def gapless_bounds(blob: bytes, total_frames: int) -> tuple[int, int] | None:
    """(start, length) window of the true audio within the decoded PCM.

    Uses the LAME tag's encoder delay/padding plus the standard
    529-sample decoder delay, so ``pcm[start : start + length]`` is the
    encoder's input sample-exactly in position and length (the raw
    decode leads with delay+529 warm-up samples and trails with
    padding-529 flush samples).  None when the stream carries no tag."""
    info = frontend.lame_gapless(blob)
    if info is None:
        return None
    start = info["delay"] + DECODER_DELAY
    if info["frames"]:
        length = (info["frames"] * info["samples_per_frame"]
                  - info["delay"] - info["padding"])
    else:
        length = total_frames - start - max(
            info["padding"] - DECODER_DELAY, 0)
    length = max(0, min(length, total_frames - start))
    if start >= total_frames:
        return None
    return start, length
