"""FLAC group decoder: host walk → packed lanes → one device program.

The host front-end (``frontend.analyze_batch``, the C++ flacfe walk)
walks each file's structure; this module packs the flat descriptors of
every file of a group into bucketed tensors and runs one
``device.flac_decode_wire`` call per chunk of files on the requested
device (rice scan, predictors, stereo, PCM assembly with the window-add
kernels on CUDA).  Two routes sit beside it, as in the JAX package:
26-32-bit streams decode on the host (``host.decode_ints``), and files
past ``frontend.BIT_CAP`` decode frame-chunked.

It is the port of the JAX package's ``codecs/flac/decoder.py``: the same
sizing, packing and chunk plan, with the byte stream of every chunk
copied to the device before the walk.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import errors as E
from ...core.batch import AudioBatch, host_audio_seconds
from ...utils.trace import TRACE, span, to_device, to_host
from . import frontend
from .device import flac_decode_wire, rice_k

#: the physical packing limit: lane bit positions ride int32 on the device.
#: Distinct from frontend.BIT_CAP (the routing policy, equal in production
#: but shrunk by tests): the chunked path packs single frames whose span
#: exceeds a shrunken BIT_CAP, and the int32 bound never moves.
POS_CAP = 1 << 31

#: pipeline granularity: packed bytes per device-program chunk
CHUNK_BYTES = 12 << 20


def _bucket(n: int, minimum: int = 1) -> int:
    """Round n up to a power of two OR 3/4 of one (two sizes per octave)."""
    size = minimum
    while size < n:
        size *= 2
    if size > minimum and n <= size // 4 * 3:
        return size // 4 * 3
    return size


def _bucket_fine(n: int, minimum: int = 1024) -> int:
    """8 geometric steps per octave for the byte tensor (padding ≤ 1/8)."""
    size = minimum
    while size < n:
        size *= 2
    if size <= minimum:
        return size
    half = size // 2
    for k in range(1, 8):
        cand = half + half * k // 8
        if n <= cand:
            return cand
    return size


def _pad1(arrs: list[np.ndarray], cap: int, dtype) -> np.ndarray:
    """Concatenate per-file 1-D descriptor arrays and zero-pad to cap."""
    out = np.zeros((cap,), dtype)
    if arrs:
        cat = np.concatenate(arrs)
        out[: cat.shape[0]] = cat
    return out


def _meta(values, device) -> torch.Tensor:
    return to_device(np.asarray(values, np.int32), device)


def _error_batch(names, codes, device) -> AudioBatch:
    n = len(names)
    z = _meta(np.zeros(n), device)
    return AudioBatch(
        data=torch.zeros((n, 1), dtype=torch.float32, device=device),
        sample_rate=z, num_channels=z.clone(), bits_per_sample=z.clone(),
        valid_frames=z.clone(), err=_meta(codes, device),
        names=tuple(names), formats=("flac",) * n,
    )


def _aligned_size(nbytes: int) -> int:
    """Per-file byte footprint in the flat stream: files start word-aligned."""
    return (nbytes + 3) // 4 * 4


def sizing_for(analyses: list[frontend.FlacAnalysis],
               combine: str = "sum") -> dict:
    """Bucketed static dims of the device program for a group.

    combine: how the flat byte tensor sizes across the analyses — "sum"
    for a group packed together (decode_group), "max" when each analysis
    packs alone against this sizing (stream / chunked paths)."""
    sizes = [_aligned_size(len(a.data)) for a in analyses]
    ntot = (sum(sizes) if combine == "sum" else max(sizes)) + 4
    # the narrow scan variant (one window read per code, 8 codes/step) is
    # legal when every rice parameter fits with Q_CAP in one 32-bit window
    narrow = all(int(a.rl_param.max(initial=0)) <= 16 for a in analyses)
    return dict(
        rice_narrow=narrow,
        ntot=_bucket_fine(ntot, 1024),
        nmax=_bucket(max(int(a.blocksizes.max()) if a.n_frames else 1
                         for a in analyses), 64),
        smax=_bucket(max(a.total for a in analyses) or 1, 256),
        rice_steps=_bucket(-(-max((int(a.rl_count.max()) for a in analyses
                                   if a.rl_count.size), default=0)
                             // rice_k(narrow)) or 1),
        fw_imax=_bucket(max((int(a.fw_count.max()) for a in analyses
                             if a.fw_count.size), default=0) or 1, 8),
        F=_bucket(sum(a.n_frames for a in analyses) or 1),
        Lr=_bucket(sum(a.rl_sub.size for a in analyses) or 1),
        Lw=_bucket(sum(a.fw_sub.size for a in analyses) or 1),
        Ld=_bucket(sum(a.dv_sub.size for a in analyses) or 1),
    )


def _plan_stream(datas: list[bytes]) -> tuple[np.ndarray, np.ndarray, int]:
    """Flat-stream layout for a list of blobs, knowable before the walk.
    Returns (file_off bits i32 [B], file_bits i32 [B], packed bytes incl.
    the +4 tail)."""
    B = len(datas)
    file_off = np.zeros((B,), np.int64)
    file_bits = np.zeros((B,), np.int64)
    at = 0
    for i, d in enumerate(datas):
        file_off[i] = at * 8
        file_bits[i] = len(d) * 8
        at += _aligned_size(len(d))
    packed = at + 4
    # bit positions ride int32 on the device: guard the actual packed size
    if packed * 8 >= POS_CAP:
        raise E.UnsupportedFormatError(
            "group exceeds int32 device bit positions; split the group")
    return file_off.astype(np.int32), file_bits.astype(np.int32), packed


def _build_stream(datas: list[bytes], file_off: np.ndarray,
                  ntot: int) -> np.ndarray:
    """Materialize the flat byte stream: files concatenate word-aligned."""
    bufs = np.zeros((ntot,), np.uint8)
    for off, d in zip(file_off, datas):
        b = off // 8
        bufs[b: b + len(d)] = np.frombuffer(d, np.uint8)
    return bufs


def _pack_np(analyses: list[frontend.FlacAnalysis],
             sizing: dict | None = None,
             stream: tuple | None = None) -> tuple[list, dict]:
    """Shared packer: per-field numpy arrays in wire order + statics.

    ``stream`` = (file_off, file_bits) skips rebuilding the byte tensor
    (fields[0] is None then)."""
    ch = analyses[0].channels
    sz = sizing or sizing_for(analyses)
    ntot, nmax, smax = sz["ntot"], sz["nmax"], sz["smax"]
    F, Lr, Lw, Ld = sz["F"], sz["Lr"], sz["Lw"], sz["Ld"]

    if stream is None:
        file_off, file_bits, _ = _plan_stream([a.data for a in analyses])
        bufs = _build_stream([a.data for a in analyses], file_off, ntot)
    else:
        file_off, file_bits = stream
        _plan_stream([a.data for a in analyses])  # re-assert the guard
        bufs = None

    # frames and sublanes concatenate in stream order, so the global
    # sublane index = (frame_base + f)*ch + c (frame-major/channel-minor)
    fr = {k: [] for k in ("file", "start", "n", "mode", "scale")}
    sub = {k: [] for k in ("kind", "order", "shift", "wasted", "coeffs")}
    rl = {k: [] for k in ("file", "sub", "bitpos", "count", "param", "dest")}
    fw = {k: [] for k in ("file", "sub", "bitpos", "count", "width", "dest")}
    dv = {k: [] for k in ("sub", "dest", "val")}
    frame_base = 0
    for i, a in enumerate(analyses):
        fr["file"].append(np.full((a.n_frames,), i, np.int32))
        fr["start"].append(a.starts.astype(np.int32))
        fr["n"].append(a.blocksizes)
        fr["mode"].append(a.ch_mode)
        fr["scale"].append(np.full((a.n_frames,), 2.0 ** (1 - a.bits),
                                   np.float32))
        sub["kind"].append(a.sub_kind)
        sub["order"].append(a.sub_order)
        sub["shift"].append(a.sub_shift)
        sub["wasted"].append(a.sub_wasted)
        sub["coeffs"].append(a.sub_coeffs)
        sub_off = frame_base * ch
        base = int(file_off[i])
        rl["file"].append(np.full(a.rl_sub.shape, i, np.int32))
        rl["sub"].append(a.rl_sub + sub_off)
        rl["bitpos"].append((a.rl_bitpos.astype(np.int64) + base).astype(np.int32))
        rl["count"].append(a.rl_count)
        rl["param"].append(a.rl_param)
        rl["dest"].append(a.rl_dest)
        fw["file"].append(np.full(a.fw_sub.shape, i, np.int32))
        fw["sub"].append(a.fw_sub + sub_off)
        fw["bitpos"].append((a.fw_bitpos.astype(np.int64) + base).astype(np.int32))
        fw["count"].append(a.fw_count)
        fw["width"].append(a.fw_width)
        fw["dest"].append(a.fw_dest)
        dv["sub"].append(a.dv_sub + sub_off)
        dv["dest"].append(a.dv_dest)
        dv["val"].append(a.dv_val)
        frame_base += a.n_frames

    # dv padding routes out of bounds (dest 0 would clobber sublane 0)
    dv_dest = np.full((Ld,), 2**31 - 1, np.int32)
    if dv["dest"]:
        cat = np.concatenate(dv["dest"])
        dv_dest[: cat.shape[0]] = cat

    coeffs = np.zeros((F * ch, 32), np.int32)
    if sub["coeffs"]:
        cat = np.concatenate(sub["coeffs"], axis=0)
        coeffs[: cat.shape[0]] = cat

    fields = (
        [bufs, file_off, file_bits]
        + [_pad1(rl[k], Lr, np.int32) for k in rl]
        + [_pad1(fw[k], Lw, np.int32) for k in fw]
        + [_pad1(dv["sub"], Ld, np.int32), dv_dest, _pad1(dv["val"], Ld, np.int32)]
        + [_pad1(sub[k], F * ch, np.int32)
           for k in ("kind", "order", "shift", "wasted")]
        + [coeffs]
        + [_pad1(fr[k], F, np.int32) for k in ("file", "start", "n", "mode")]
        + [_pad1(fr["scale"], F, np.float32)]
    )
    statics = dict(channels=ch, nmax=nmax, smax=smax,
                   rice_steps=sz["rice_steps"], fw_imax=sz["fw_imax"],
                   rice_narrow=sz.get("rice_narrow", False))
    return fields, statics


def pack_group(analyses: list[frontend.FlacAnalysis], device,
               sizing: dict | None = None) -> tuple[tuple, dict]:
    """Pack one same-channel-count group into ``device.flac_decode_batch``'s
    ``(positional tensors on device, static kwargs)``."""
    fields, statics = _pack_np(analyses, sizing)
    return tuple(to_device(f, device) for f in fields), statics


def pack_wire(analyses: list[frontend.FlacAnalysis], device,
              sizing: dict | None = None,
              stream: tuple | None = None) -> tuple[tuple, dict]:
    """Pack for ``device.flac_decode_wire``: (bytes, desc) — every
    descriptor field concatenated into ONE int32 tensor, so a group costs
    two host-to-device copies.

    ``stream`` = (bufs_dev, file_off, file_bits): a byte tensor already on
    the device (decode_group copies it before the walk); its layout MUST
    match _plan_stream's for the same file list."""
    with span("flac.pack"):
        if stream is not None:
            bufs_dev, file_off, file_bits = stream
            fields, statics = _pack_np(analyses, sizing,
                                       stream=(file_off, file_bits))
        else:
            fields, statics = _pack_np(analyses, sizing)
            bufs_dev = to_device(fields[0], device)
        B = fields[1].shape[0]
        Lr, Lw, Ld = fields[3].shape[0], fields[9].shape[0], fields[15].shape[0]
        F = fields[23].shape[0]
        desc = np.concatenate(
            [f.reshape(-1) for f in fields[1:27]]
            + [np.ascontiguousarray(fields[27]).view(np.int32)])
        statics = dict(statics, B=B, F=F, Lr=Lr, Lw=Lw, Ld=Ld)
        return (bufs_dev, to_device(desc, device)), statics


def _decode_batch(analyses: list[frontend.FlacAnalysis], names: list[str],
                  device, sizing: dict | None = None,
                  stream: tuple | None = None) -> AudioBatch:
    """Pack one same-channel-count group and run the device program."""
    B = len(analyses)
    ch = analyses[0].channels
    args, statics = pack_wire(analyses, device, sizing, stream=stream)
    pcm, ovf = flac_decode_wire(*args, **statics)
    err = torch.where(ovf, E.ERR_INVALID, 0).to(torch.int32)
    return AudioBatch(
        data=pcm, channels=ch,
        sample_rate=_meta([a.sample_rate for a in analyses], device),
        num_channels=_meta(np.full((B,), ch), device),
        bits_per_sample=_meta([a.bits for a in analyses], device),
        valid_frames=_meta([a.total for a in analyses], device),
        err=err, names=tuple(names), formats=("flac",) * B,
    )


def _host_piece(idxs: list[int], assets, device
                ) -> tuple[list[int], AudioBatch, float]:
    """Decode 26-32-bit files on the host (int64-exact; host.decode_ints)
    and batch the nearest-f32 PCM — the f32 surface is lossless through
    25 bits, same contract as 32-bit-int WAV.  Returns the piece and its
    decoded audio-seconds."""
    from . import host

    names, codes, pcms, infos = [], [], [], []
    for i in idxs:
        names.append(assets[i].name)
        try:
            ints, info = host.decode_ints(assets[i].data)
            pcms.append(ints.astype(np.float64) * 2.0 ** (1 - info["bits"]))
            infos.append(info)
            codes.append(0)
        except E.DecodeError as e:
            pcms.append(np.zeros((0, 1)))
            infos.append(dict(rate=0, channels=0, bits=0, total=0))
            codes.append(e.code)
    smax = max((p.shape[0] for p in pcms), default=1) or 1
    cmax = max((p.shape[1] for p in pcms), default=1) or 1
    data = np.zeros((len(idxs), smax * cmax), np.float32)
    for k, p in enumerate(pcms):
        if p.size:
            row = np.zeros((smax, cmax), np.float32)
            row[: p.shape[0], : p.shape[1]] = p.astype(np.float32)
            data[k] = row.reshape(-1)
    return idxs, AudioBatch(
        data=to_device(data, device), channels=cmax,
        sample_rate=_meta([i_["rate"] for i_ in infos], device),
        num_channels=_meta([i_["channels"] for i_ in infos], device),
        bits_per_sample=_meta([i_["bits"] for i_ in infos], device),
        valid_frames=_meta([i_["total"] for i_ in infos], device),
        err=_meta(codes, device),
        names=tuple(names), formats=("flac",) * len(idxs),
    ), host_audio_seconds([i_["total"] for i_ in infos],
                          [i_["rate"] for i_ in infos])


def _chunked_piece(i: int, an: frontend.FlacAnalysis, name: str, device
                   ) -> tuple[list[int], AudioBatch, float]:
    """One-shot decode of a >BIT_CAP file through the frame-chunked path
    (stream.slice_frames rebases every chunk's bit positions near zero,
    so int32 device lanes hold them no matter the file size).  Returns the
    piece and its decoded audio-seconds."""
    from .stream import slice_frames

    F = an.n_frames
    # greedy frame windows: each chunk's byte span stays far inside the
    # cap, and at most 2048 frames so device memory stays bounded
    byte_cap = max(frontend.BIT_CAP // 8 // 16,
                   int((an.byte_offs[1:] - an.byte_offs[:-1]).max()))
    cuts = [0]
    while cuts[-1] < F:
        a = cuts[-1]
        b = min(a + 2048, F)
        while b > a + 1 and int(an.byte_offs[b] - an.byte_offs[a]) > byte_cap:
            b = a + max(1, (b - a) // 2)
        cuts.append(b)
    outs = []
    slices = [slice_frames(an, a, b) for a, b in zip(cuts, cuts[1:])]
    sz = sizing_for(slices, combine="max") if slices else None
    for sl in slices:
        b = _decode_batch([sl], [name], device, sizing=sz)
        code = int(to_host(b.err[:1])[0])
        if code:
            # a bad chunk fails THIS file (error piece), not the family
            return [i], _error_batch([name], [code], device), 0.0
        outs.append(b.data[0].reshape(-1, b.channels)[: sl.total])
    pcm = (torch.cat(outs, dim=0) if outs
           else torch.zeros((0, an.channels), dtype=torch.float32, device=device))
    return [i], AudioBatch(
        data=pcm.reshape(1, -1), channels=an.channels,
        sample_rate=_meta([an.sample_rate], device),
        num_channels=_meta([an.channels], device),
        bits_per_sample=_meta([an.bits], device),
        valid_frames=_meta([an.total], device),
        err=_meta([0], device),
        names=(name,), formats=("flac",),
    ), host_audio_seconds([an.total], [an.sample_rate])


def decode_group(assets, *, device) -> list[tuple[list[int], AudioBatch]]:
    """Family decoder: ``[(family_local_indices, AudioBatch), ...]`` on
    ``device``.

    STREAMINFO (a cheap header parse) routes and chunk-plans every file
    before the walk, so each chunk's flat byte stream is copied to the
    device before the native walk runs.  Per-file walk failures become
    error-batch pieces.  Beside the device program, 26-32-bit streams
    decode on the host and files past BIT_CAP decode frame-chunked — no
    legal RFC 9639 stream is rejected."""
    host_route: list[int] = []
    walk_idx: list[int] = []
    chans: dict[int, int] = {}

    for i, a in enumerate(assets):
        try:
            si = frontend.parse_streaminfo(a.data)
            if si["bits"] > frontend.MAX_BPS:
                host_route.append(i)
                continue
            chans[i] = si["channels"]
        except E.DecodeError:
            pass  # let the walk assign the authoritative error code
        walk_idx.append(i)

    # --- pre-walk chunk plan: same-channel files, flushed at CHUNK_BYTES
    #     and the packed-size caps
    big: list[int] = []
    plans: list[list[int]] = []
    cur: dict[int, tuple[list[int], int]] = {}
    cap_bytes = min(frontend.BIT_CAP, POS_CAP) // 8
    for i in walk_idx:
        ch = chans.get(i)
        if ch is None:
            continue  # the walk fails it with the authoritative code
        fb = _aligned_size(len(assets[i].data))
        # admission mirrors _plan_stream's guard on the packed size
        if fb + 8 >= cap_bytes:
            big.append(i)
            continue
        sub, bts = cur.get(ch, ([], 0))
        if sub and (bts + fb + 8 >= cap_bytes or bts + fb > CHUNK_BYTES):
            plans.append(sub)
            sub, bts = [], 0
        sub.append(i)
        cur[ch] = (sub, bts + fb)
    plans.extend(sub for sub, _ in cur.values() if sub)

    # --- early copy: every chunk's byte stream goes to the device now,
    #     before the walk; the layout needs only byte lengths
    pending = []
    for sub in plans:
        datas = [assets[i].data for i in sub]
        file_off, file_bits, packed = _plan_stream(datas)
        ntot = _bucket_fine(packed, 1024)
        with span("flac.h2d"):
            bufs_dev = to_device(_build_stream(datas, file_off, ntot), device)
        pending.append((sub, bufs_dev, file_off, file_bits, ntot))

    analyses: dict[int, frontend.FlacAnalysis] = {}
    failed: list[tuple[int, int]] = []
    with span("flac.walk"):
        # one native session walks every blob exactly once, threaded in C
        results = frontend.analyze_batch([assets[i].data for i in walk_idx])
        for i, r in zip(walk_idx, results):
            if isinstance(r, E.DecodeError):
                failed.append((i, r.code))
            else:
                analyses[i] = r

    pieces: list[tuple[list[int], AudioBatch]] = []
    seconds = 0.0  # decoded audio-seconds, from the host's metadata
    if failed:
        pieces.append((
            [i for i, _ in failed],
            _error_batch([assets[i].name for i, _ in failed],
                         [c for _, c in failed], device),
        ))
    if host_route:
        with span("flac.host"):
            idxs, batch, secs = _host_piece(host_route, assets, device)
        pieces.append((idxs, batch))
        seconds += secs

    for sub, bufs_dev, file_off, file_bits, ntot in pending:
        ok = [i for i in sub if i in analyses]
        if not ok:
            continue  # every file already in the error piece
        with span("flac.device"):
            if len(ok) == len(sub):
                sz = sizing_for([analyses[i] for i in sub])
                sz["ntot"] = ntot  # MUST match the pre-copied tensor
                batch = _decode_batch(
                    [analyses[i] for i in sub],
                    [assets[i].name for i in sub], device, sizing=sz,
                    stream=(bufs_dev, file_off, file_bits))
            else:
                # a walk failure inside a pre-copied chunk: repack the
                # survivors fresh (their bytes copy again)
                batch = _decode_batch([analyses[i] for i in ok],
                                      [assets[i].name for i in ok], device)
        pieces.append((ok, batch))
        seconds += host_audio_seconds([analyses[i].total for i in ok],
                                      [analyses[i].sample_rate for i in ok])
    for i in big:
        if i in analyses:
            with span("flac.device"):
                idxs, batch, secs = _chunked_piece(i, analyses[i],
                                                   assets[i].name, device)
            pieces.append((idxs, batch))
            seconds += secs
    TRACE.add("decode.flac", seconds)
    return pieces
