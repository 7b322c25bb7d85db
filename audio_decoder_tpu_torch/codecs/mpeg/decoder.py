"""Batched MPEG audio decode orchestration, routed by layer.

Layer III: the host front-end (the C++ ``mp3fe`` library, native.py)
walks every blob once and emits the raw main_data bytes plus per-lane
side metadata; the entropy decode and DSP then run as one
``dsp.mp3_decode_fused`` call per (channels, joint-stereo,
granules-per-frame) group on the requested device.  Granule counts and
main_data widths are padded to buckets.

Layers I/II: the host fixed-width walk (``layer12.analyze_l1``/
``analyze_l2``) emits dense codes, classes and scalefactor indices; one
``layer12.l12_synthesize`` call per channel count requantizes them and
runs the synthesis on the device.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING

import numpy as np
import torch
from torch.profiler import record_function

from ...core import errors as E
from ...core.batch import AudioBatch
from ...utils.trace import TRACE
from . import layer12 as L12
from . import native
from .dsp import compact_lane_wire, mp3_decode_fused

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
        err=torch.as_tensor(np.asarray(codes, np.int32), device=device),
        names=tuple(names),
        formats=("mp3",) * n,
    )


def _rate_idx_arr(sample_rate: np.ndarray) -> np.ndarray:
    from . import tables as T

    out = np.zeros(len(sample_rate), np.int32)
    for i, sr in enumerate(np.asarray(sample_rate)):
        out[i] = T.RATE_IDX.get(int(sr), 0)
    return out


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
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a).reshape(shape)),
                               device=device)

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
        r = sess.lanes_batch([sess_idx[i] for i in idxs], g_cap, m_cap, ch)
        act = r["valid"].reshape(-1) > 0
        bvs = r["big"].reshape(-1)[act]
        # pairs beyond 288 still consume bits (count1 cursor), so n_big
        # follows the true max big_values (<= 511), not the 576-line cap
        n_big = 32 if bvs.size == 0 else min(512, int(-(-int(bvs.max()) // 32) * 32))
        perm, buckets = _plan_buckets(
            r["big"].reshape(-1), r["valid"].reshape(-1), n_big
        )
        pcm = mp3_decode_fused(
            *fused_wire_args(r, _rate_idx_arr(r["sample_rate"]), device),
            None if perm is None else torch.as_tensor(perm, device=device),
            channels=ch,
            joint_stereo=joint,
            granules_per_frame=gpf,
            buckets=buckets,
        )

        def meta(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        batch = AudioBatch(
            data=pcm, channels=ch,
            sample_rate=meta(r["sample_rate"]),
            num_channels=meta(r["channels"]),
            bits_per_sample=meta(np.full((B,), 16)),  # MP3 nominal depth
            valid_frames=meta(r["n_granules"] * 576),
            err=meta(r["err"]),
            names=tuple(assets[i].name for i in idxs),
            formats=("mp3",) * B,
        )
        pieces.append((idxs, batch))
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
    return tuple(torch.as_tensor(x, device=device)
                 for x in (codes, cls, sf_idx))


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
    with TRACE.stage("l12/analyze"), record_function("l12.analyze"):
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

        def meta(vals):
            return torch.as_tensor(np.asarray(vals, np.int32), device=device)

        batch = AudioBatch(
            data=pcm, channels=ch,
            sample_rate=meta([a.sample_rate for a in ans]),
            num_channels=meta([a.channels for a in ans]),
            bits_per_sample=meta(np.full((B,), 16)),
            valid_frames=meta([a.n_frames * steps * 32 for a in ans]),
            err=meta(np.zeros((B,))),
            names=tuple(assets[i].name for i in idxs),
            formats=(f"mp{layer}",) * B,
        )
        pieces.append((idxs, batch))
    return pieces


def decode_group(assets: "list[Asset]", *, device) -> list[tuple[list[int], AudioBatch]]:
    """Decode a group of MPEG-audio assets → (local_indices, AudioBatch)
    pieces on ``device``.

    Every blob is frame-walked once by an ``Mp3Session``, which routes by
    the layer of the first valid frame and serves the Layer III grouping
    probes and lane emission from its stored frame tables.  Layers I/II
    take the fixed-width subband path; Layer III (or undetected: the
    fused path reports its errors) the fused on-device-Huffman path."""
    with native.Mp3Session([a.data for a in assets]) as sess:
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
