"""FLAC device decode — rice scan, predictors, stereo, assembly.

One call decodes a whole batch of FLAC files from raw bytes to flat
interleaved ``[B, smax * channels]`` float32 PCM on the tensors' device:

1. **Rice lane scan** — each lane is one rice-coded partition; a step
   decodes ``rice_k(narrow)`` codes per lane: unary quotient =
   count-leading-zeros of the 32-bit window at the cursor, remainder = a
   shift of the same window (narrow) or one more window read (wide).
2. **Fixed-width lanes** — warmup samples, VERBATIM bodies, CONSTANT
   values and escaped partitions: value i sits at ``bitpos + i*width``.
3. **Value assembly** — the rice and fixed-width lanes land in one flat
   value array through K4 (ops/window_add.window_add2), plus the
   host-decoded quotient outliers.
4. **Predictor reconstruction** — every subframe is an integer LPC
   (FIXED = spec coefficients with shift 0, VERBATIM = order 0), one
   sample step at a time over all subframes.
5. **Stereo decorrelation and PCM assembly** — per-frame channel solves,
   then K3 (ops/window_add.window_add) places every frame in its file's
   row.

It is the port of the JAX package's ``codecs/flac/device.py``.  Bit
windows are read in int64 straight from the flat byte stream (torch has
no uint32 shifts on the CPU, and an int32 ``>>`` is arithmetic); bytes
past the stream read as zero, as the JAX program's padded words do, and an
int64 → int32 conversion wraps, as the JAX program's int32 arithmetic.  The
quotient cap and the outlier routing are the JAX package's: lanes that
see q > Q_CAP raise the per-file overflow flag.

Over a mesh (``flac_decode_batch(..., mesh=)``, parallel/decode.py's
``sharded_flac_fn``) the lanes and frames shard over ``data`` and the
assemblies are K5 calls (ops/window_add.window_add_spmd: K3 per shard plus
one psum), two for the values and one for the PCM, as in the JAX
package's mesh route.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ...ops.bytes import peek32
from ...ops.window_add import window_add, window_add2
from .frontend import Q_CAP  # max in-lane unary quotient

# Rice scan geometry, as in the JAX program: the narrow variant (every rice
# parameter <= 16) reads a whole code from one 32-bit window, 8 codes per
# step; the wide variant reads the remainder from a second window, 6 codes
# per step.  K_MAX bounds the bits a step reads past its start cursor.
assert Q_CAP < 32
K_NARROW, K_WIDE = 8, 6
K_MAX_NARROW = (K_NARROW - 1) * (Q_CAP + 1 + 16)
K_MAX_WIDE = (K_WIDE - 1) * (Q_CAP + 1 + 31) + Q_CAP + 1
K_MAX = K_MAX_WIDE  # padding worst case

#: per-stream word padding of the JAX program (enters the scan limit)
PAD_WORDS = -(-(K_MAX // 32 + 24) // 8) * 8

_M32 = 0xFFFFFFFF


def rice_k(narrow: bool) -> int:
    """Rice codes per scan step for the batch's parameter class."""
    return K_NARROW if narrow else K_WIDE


def _scan_limit_cap(n_bytes: int) -> int:
    """The JAX program's static bound on a lane's scan limit: the bit
    length of its padded big-endian word view of the stream (``_be_words``
    there; this port reads the bytes directly) less the scan's lookahead,
    clamped to int32."""
    n_words = -(-n_bytes // 4)
    n_words += (-n_words) % 4 + PAD_WORDS
    return min(n_words * 32 - K_MAX - 256, 2**31 - 1)


def _clz32(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (32 for zero)."""
    n = torch.zeros_like(w)
    for s in (16, 8, 4, 2, 1):
        top = (w >> (32 - s)) == 0
        n = n + torch.where(top, s, 0)
        w = torch.where(top, (w << s) & _M32, w)
    return n + (w == 0).to(n.dtype)


def _sign_extend(u: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Two's-complement sign extension of ``width``-bit values held in
    int64 (vector width, 0 yields 0) → int32."""
    sign = (u >> (width - 1).clamp(min=0)) & 1
    return torch.where(width > 0, (u - (sign << width)).to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=u.device))


def _rice_scan(stream, bitpos, count, param, limit, steps: int,
               narrow: bool):
    """Lane-parallel rice decode: ``[L]`` lanes, ``steps * rice_k(narrow)``
    codes each (codes past ``count`` are decoded and discarded with the
    cursor frozen).  Returns (values i32 ``[L, steps*K]``, ovf bool ``[L]``)."""
    i64 = torch.int64
    rows = stream.view(1, -1)
    kc = rice_k(narrow)
    param = param.to(i64)
    pshift = (32 - param).clamp(min=1)
    limit = limit.to(i64)
    count = count.to(i64)
    pos = torch.minimum(bitpos.to(i64), limit)
    ovf = torch.zeros(bitpos.shape, dtype=torch.bool, device=bitpos.device)
    outs = []
    for step in range(steps):
        off = torch.zeros_like(pos)
        for k in range(kc):
            live = step * kc + k < count
            w1 = peek32(rows, 0, pos + off)
            # Q_CAP < 32: the unary quotient fits one window read (an
            # all-zero window reads as q = 32 > Q_CAP -> ovf)
            q = _clz32(w1)
            ovf = ovf | (live & (q > Q_CAP))
            q = q.clamp(max=Q_CAP)
            if narrow:
                # q+1+param <= 32: the whole code rides w1
                rem = ((w1 << (q + 1)) & _M32) >> pshift
            else:
                rem = peek32(rows, 0, pos + off + q + 1) >> pshift
            rem = torch.where(param > 0, rem, 0)
            v = (((q << param) & _M32) | rem).to(torch.int32)
            outs.append((v >> 1) ^ -(v & 1))  # unzigzag, in int32
            off = off + torch.where(live, q + 1 + param, 0)
        pos = torch.minimum(pos + off, limit)
    if not outs:
        return torch.zeros((bitpos.shape[0], 0), dtype=torch.int32,
                           device=bitpos.device), ovf
    return torch.stack(outs, dim=1), ovf


def _fixed_width(stream, bitpos, width, limit, imax: int):
    """Position-parallel fixed-width signed reads: value i of lane l is the
    ``width[l]``-bit field at ``bitpos[l] + i*width[l]`` (cursor clamped at
    the lane's limit).  Returns i32 ``[L, imax]`` (width 0 → zeros)."""
    i64 = torch.int64
    w = width.to(i64)[:, None]
    i = torch.arange(imax, dtype=i64, device=bitpos.device)[None, :]
    pos = torch.minimum(bitpos.to(i64)[:, None] + i * w, limit.to(i64)[:, None])
    u = peek32(stream.view(1, -1), 0, pos) >> (32 - w).clamp(min=1)
    return _sign_extend(torch.where(w > 0, u, 0), w.expand_as(u))


def _exact_mac(hist: torch.Tensor, coef: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """``(sum_j coef[j] * hist[j]) >> shift`` wrapped to int32.

    The JAX program rebuilds the 46-bit sum from an i32 and an f32 dot
    (the TPU has no int64); here the sum is exact in int64 (|coef| < 2^15,
    |hist| < 2^31, 32 terms), and its arithmetic shift, wrapped to int32,
    is the JAX program's result on every in-contract input."""
    acc = (hist.to(torch.int64) * coef.to(torch.int64)).sum(dim=1)
    return (acc >> shift.to(torch.int64)).to(torch.int32)


def _predict(vals, kind, order, shift, wasted, coeffs, nmax: int):
    """Reconstruct samples from residuals+warmup for every sublane.

    ``vals`` i32 ``[Ls, nmax]``: positions < order hold warmup samples, the
    rest residuals.  LPC recurrence s[i] = r[i] + (Σ c[j]·s[i-1-j] >>
    shift), one sample step at a time (the shift truncation makes it
    serial); FIXED and VERBATIM ride the same path (integer coefficients /
    order 0).  The samples live in one int64 buffer behind 32 zeros of
    history, so step i reads its history as the view ``buf[:, i:i+32]``
    against the reversed coefficients: no per-step concatenation."""
    Ls = vals.shape[0]
    dev = vals.device
    coef_rev = coeffs.to(torch.int64).flip(1)          # [Ls, 32]
    sh = shift.to(torch.int64)
    buf = torch.zeros((Ls, nmax + 32), dtype=torch.int64, device=dev)
    buf[:, 32:] = vals[:, :nmax]
    res = vals[:, :nmax].to(torch.int32)
    warm = order[:, None] > torch.arange(32, device=dev)[None, :]  # [Ls, 32]
    for i in range(nmax):
        s = _exact_mac(buf[:, i:i + 32], coef_rev, sh) + res[:, i]  # wraps
        if i < 32:  # warmup samples pass through
            s = torch.where(warm[:, i], res[:, i], s)
        buf[:, 32 + i] = s
    out = buf[:, 32:].to(torch.int32)
    out = torch.where(kind[:, None] == 1, vals[:, :1], out)  # CONSTANT
    return out << wasted[:, None]


def _stereo(sub_pcm, fr_mode, channels: int):
    """Undo inter-channel decorrelation: ``[F, C, N]`` coded channels →
    ``[F, C, N]`` L/R samples, selected per frame mode (0 independent,
    8 left/side, 9 side/right, 10 mid/side)."""
    if channels != 2:
        return sub_pcm
    a, b = sub_pcm[:, 0], sub_pcm[:, 1]
    m = fr_mode[:, None]
    m2 = (a << 1) | (b & 1)
    left = torch.where(m == 8, a,
           torch.where(m == 9, a + b,
           torch.where(m == 10, (m2 + b) >> 1, a)))
    right = torch.where(m == 8, a - b,
            torch.where(m == 9, b,
            torch.where(m == 10, (m2 - b) >> 1, b)))
    return torch.stack([left, right], dim=1)


def _lane_windows(bytes_u8, limit, rl_file, rl_bitpos, rl_count, rl_param,
                  rl_sub, rl_dest, fw_file, fw_bitpos, fw_count, fw_width,
                  fw_sub, fw_dest, *, nmax: int, rice_steps: int,
                  fw_imax: int, rice_narrow: bool):
    """The value windows of the fixed-width and rice lanes: (rl_starts,
    rl_upd, fw_starts, fw_upd, per-lane overflow).  Every value source
    lands at a contiguous per-lane window (dest = lane base + i), in stream
    order == destination order, the window-add kernels' contract."""
    dev = bytes_u8.device
    W = rice_steps * rice_k(rice_narrow)
    with record_function("flac.fixed_width"):
        fwv = _fixed_width(bytes_u8, fw_bitpos, fw_width,
                           limit[fw_file.long()], fw_imax)
        fvalid = (torch.arange(fw_imax, device=dev)[None, :]
                  < fw_count[:, None])
        fw_starts = (fw_sub * (nmax + 1) + fw_dest).to(torch.int32)
        fw_upd = torch.where(fvalid, fwv, 0)
    with record_function("flac.rice_scan"):
        rv, ovf_l = _rice_scan(bytes_u8, rl_bitpos, rl_count, rl_param,
                               limit[rl_file.long()], rice_steps, rice_narrow)
        rvalid = torch.arange(W, device=dev)[None, :] < rl_count[:, None]
        rl_starts = (rl_sub * (nmax + 1) + rl_dest).to(torch.int32)
        rl_upd = torch.where(rvalid, rv, 0)
    return rl_starts, rl_upd, fw_starts, fw_upd, ovf_l


def _direct_values(vals_flat, dv_sub, dv_dest, dv_val, nmax: int):
    """Add the host-decoded quotient outliers into the flat values;
    padding rows carry an out-of-range dest and drop."""
    with record_function("flac.direct_values"):
        n_vals = vals_flat.shape[0]
        dv_idx = dv_sub.to(torch.int64) * (nmax + 1) + dv_dest.to(torch.int64)
        keep = (dv_idx >= 0) & (dv_idx < n_vals)
        return vals_flat.index_put(
            (torch.where(keep, dv_idx, 0),),
            torch.where(keep, dv_val, 0), accumulate=True)


def _frame_windows(vals, sub_kind, sub_order, sub_shift, sub_wasted,
                   sub_coeffs, fr_file, fr_start, fr_n, fr_mode, fr_scale, *,
                   channels: int, nmax: int, smax: int):
    """Subframe values ``[Ls, nmax]`` (frame-major, Ls = F * channels) →
    the PCM windows (starts, upd ``[F, nmax * channels]``): predictors,
    stereo, scale; one frame's samples land contiguously in the flat
    interleaved output."""
    dev = vals.device
    F = fr_file.shape[0]
    with record_function("flac.predict"):
        s = _predict(vals, sub_kind, sub_order, sub_shift, sub_wasted,
                     sub_coeffs, nmax)
    with record_function("flac.stereo"):
        sub_pcm = _stereo(s.reshape(F, channels, nmax), fr_mode, channels)
        pcm_f = sub_pcm.to(torch.float32) * fr_scale[:, None, None]
        W_pcm = nmax * channels
        jvalid = ((torch.arange(W_pcm, device=dev)[None, :] // channels)
                  < fr_n[:, None])
        upd = torch.where(jvalid, pcm_f.transpose(1, 2).reshape(F, W_pcm), 0.0)
        starts = (fr_file * (smax * channels) + fr_start * channels).to(torch.int32)
    return starts, upd


def _scan_limit(file_off, file_bits, n_bytes: int):
    """Each file's scan limit (absolute bits), int64 ``[B]``."""
    i64 = torch.int64
    return torch.minimum(file_off.to(i64) + file_bits.to(i64),
                         torch.tensor(_scan_limit_cap(n_bytes), dtype=i64,
                                      device=file_off.device))


def flac_decode_batch(
    bytes_u8,       # u8 [Ntot] raw bytes of ALL files, concatenated
    file_off,       # i32 [B] absolute start BIT of each file
    file_bits,      # i32 [B] valid bit length per file
    rl_file, rl_sub, rl_bitpos, rl_count, rl_param, rl_dest,  # [Lr]
    fw_file, fw_sub, fw_bitpos, fw_count, fw_width, fw_dest,  # [Lw]
    dv_sub, dv_dest, dv_val,                                  # [Ld]
    sub_kind, sub_order, sub_shift, sub_wasted,               # [Ls]
    sub_coeffs,                                               # [Ls, 32]
    fr_file, fr_start, fr_n, fr_mode,                         # [F]
    fr_scale,                                                 # f32 [F]
    *,
    channels: int,
    nmax: int,
    smax: int,
    rice_steps: int,
    fw_imax: int,
    rice_narrow: bool = False,
    stage: str = "full",
    mesh=None,
):
    """Whole-batch FLAC decode → (pcm f32 ``[B, smax*channels]``, ovf bool
    ``[B]``).  Sublanes are frame-major/channel-minor, so Ls == F *
    channels.  Lane bit positions are absolute into the flat stream; the
    per-file lane index selects the scan limit and the overflow slot.

    ``stage="windows"`` stops before K3 and returns the two window-add
    calls' inputs instead: ``{"window_add2": (rl_starts, rl_upd,
    fw_starts, fw_upd, n_vals), "window_add": (starts, upd, n_pcm)}``.

    With a ``mesh`` (parallel/mesh.py) the decode runs sharded
    (``_decode_on_mesh``) and returns ``Sharded`` pcm and ovf."""
    if mesh is not None:
        if stage != "full":
            raise ValueError("the mesh route decodes stage='full' only")
        return _decode_on_mesh(
            mesh, bytes_u8, file_off, file_bits,
            rl_file, rl_sub, rl_bitpos, rl_count, rl_param, rl_dest,
            fw_file, fw_sub, fw_bitpos, fw_count, fw_width, fw_dest,
            dv_sub, dv_dest, dv_val, sub_kind, sub_order, sub_shift,
            sub_wasted, sub_coeffs, fr_file, fr_start, fr_n, fr_mode,
            fr_scale, channels=channels, nmax=nmax, smax=smax,
            rice_steps=rice_steps, fw_imax=fw_imax, rice_narrow=rice_narrow)
    dev = bytes_u8.device
    limit = _scan_limit(file_off, file_bits, bytes_u8.shape[0])
    Ls = sub_kind.shape[0]
    W = rice_steps * rice_k(rice_narrow)
    n_vals = Ls * (nmax + 1) + max(W, fw_imax)

    rl_starts, rl_upd, fw_starts, fw_upd, ovf_l = _lane_windows(
        bytes_u8, limit, rl_file, rl_bitpos, rl_count, rl_param, rl_sub,
        rl_dest, fw_file, fw_bitpos, fw_count, fw_width, fw_sub, fw_dest,
        nmax=nmax, rice_steps=rice_steps, fw_imax=fw_imax,
        rice_narrow=rice_narrow)
    with record_function("flac.window_add2"):
        # both lane sets into the flat values in one pass: K4
        k4_args = (rl_starts, rl_upd, fw_starts, fw_upd, n_vals)
        vals_flat = window_add2(*k4_args)
    vals_flat = _direct_values(vals_flat, dv_sub, dv_dest, dv_val, nmax)
    vals = vals_flat[: Ls * (nmax + 1)].reshape(Ls, nmax + 1)[:, :nmax]

    # the frame-to-file assembly is K3 over [F, nmax*C] rows
    starts, upd = _frame_windows(
        vals, sub_kind, sub_order, sub_shift, sub_wasted, sub_coeffs,
        fr_file, fr_start, fr_n, fr_mode, fr_scale, channels=channels,
        nmax=nmax, smax=smax)
    B_out = file_bits.shape[0]
    n_pcm = B_out * smax * channels + nmax * channels
    if stage == "windows":
        return {"window_add2": k4_args, "window_add": (starts, upd, n_pcm)}
    with record_function("flac.window_add"):
        out = window_add(starts, upd, n_pcm)
        pcm = out[: B_out * smax * channels].reshape(B_out, smax * channels)

    ovf = torch.zeros((B_out,), dtype=torch.int32, device=dev)
    ovf = ovf.index_put((rl_file.long(),), ovf_l.to(torch.int32), accumulate=True)
    return pcm, ovf > 0


def _decode_on_mesh(mesh, bytes_u8, file_off, file_bits, *desc, channels: int,
                    nmax: int, smax: int, rice_steps: int, fw_imax: int,
                    rice_narrow: bool):
    """``flac_decode_batch`` over a mesh: the byte stream replicated on the
    ``data`` devices, the file, lane, subframe and frame descriptors sharded
    over ``data``.

    Each data shard scans its own lanes, on its own device, against the
    whole per-file ``limit`` (an all-gather of two ``[B]`` arrays: lanes
    index files globally).  The values are two K5 calls
    (ops/window_add.window_add_spmd), K3 per shard plus one psum each, so
    every data shard's device holds all of them (lanes index subframe rows
    globally); the outliers are added once to that sum there.  The sums go
    to the ``data`` devices only: the devices of model j > 0 read none of
    a decode's results.  Each shard then
    reconstructs its own frames (subframe shards follow the frame shards,
    Ls = F * channels frame-major) and the PCM is one more K5 call.  The
    per-file overflow is a second psum (an OR as a sum > 0).  Returns
    ``Sharded`` pcm ``[B, smax*channels]`` and ovf ``[B]`` over files.
    Every output element gets one nonzero term, so the result equals the
    single-device decode bit for bit."""
    from ...ops.window_add import window_add_spmd
    from ...parallel import mesh as M

    (rl_file, rl_sub, rl_bitpos, rl_count, rl_param, rl_dest,
     fw_file, fw_sub, fw_bitpos, fw_count, fw_width, fw_dest,
     dv_sub, dv_dest, dv_val, sub_kind, sub_order, sub_shift, sub_wasted,
     sub_coeffs, fr_file, fr_start, fr_n, fr_mode, fr_scale) = [
        M.shard(a, mesh) for a in desc]
    devs = mesh.axis_devices("data")
    byts = M.replicate(bytes_u8, mesh, devs)
    off, bits = M.shard(file_off, mesh), M.shard(file_bits, mesh)
    n_bytes = byts.value.shape[0]
    off_all, bits_all = (M.all_gather(a, mesh, devs) for a in (off, bits))
    D = len(devs)
    Ls = sum(s.shape[0] for s in sub_kind.shards)
    B_out = sum(s.shape[0] for s in off.shards)
    W = rice_steps * rice_k(rice_narrow)
    n_vals = Ls * (nmax + 1) + max(W, fw_imax)

    sets = []
    for i, d in enumerate(devs):
        lim = _scan_limit(off_all.on(d), bits_all.on(d), n_bytes)
        sets.append(_lane_windows(
            byts.on(d), lim, *(a.shards[i] for a in (
                rl_file, rl_bitpos, rl_count, rl_param, rl_sub, rl_dest,
                fw_file, fw_bitpos, fw_count, fw_width, fw_sub, fw_dest)),
            nmax=nmax, rice_steps=rice_steps, fw_imax=fw_imax,
            rice_narrow=rice_narrow))
    with record_function("flac.window_add_spmd"):
        rl_vals = window_add_spmd(M.Sharded(tuple(s[0] for s in sets)),
                                  M.Sharded(tuple(s[1] for s in sets)),
                                  n_vals, mesh=mesh, to=devs)
        fw_vals = window_add_spmd(M.Sharded(tuple(s[2] for s in sets)),
                                  M.Sharded(tuple(s[3] for s in sets)),
                                  n_vals, mesh=mesh, to=devs)
    dv = [M.all_gather(a, mesh, devs) for a in (dv_sub, dv_dest, dv_val)]
    vals_flat = {}
    for d in dict.fromkeys(devs):
        v = rl_vals.on(d) + fw_vals.on(d)
        vals_flat[d] = _direct_values(v, *(a.on(d) for a in dv), nmax)

    rows = Ls // D
    frames = []
    for i, d in enumerate(devs):
        vals = vals_flat[d][i * rows * (nmax + 1):(i + 1) * rows * (nmax + 1)]
        frames.append(_frame_windows(
            vals.reshape(rows, nmax + 1)[:, :nmax],
            *(a.shards[i] for a in (sub_kind, sub_order, sub_shift, sub_wasted,
                                    sub_coeffs, fr_file, fr_start, fr_n,
                                    fr_mode, fr_scale)),
            channels=channels, nmax=nmax, smax=smax))
    n_pcm = B_out * smax * channels + nmax * channels
    with record_function("flac.window_add_spmd"):
        out = window_add_spmd(M.Sharded(tuple(f[0] for f in frames)),
                              M.Sharded(tuple(f[1] for f in frames)),
                              n_pcm, mesh=mesh, to=devs)
    ovf = M.psum([torch.zeros((B_out,), dtype=torch.int32, device=d).index_put(
        (rl_file.shards[i].long(),), s[4].to(torch.int32), accumulate=True)
        for i, (d, s) in enumerate(zip(devs, sets))], mesh, devs)
    per = B_out // D
    pcm = M.Sharded(tuple(
        out.on(d)[i * per * smax * channels:(i + 1) * per * smax * channels]
        .reshape(per, smax * channels) for i, d in enumerate(devs)))
    return pcm, M.Sharded(tuple(ovf.on(d)[i * per:(i + 1) * per] > 0
                                for i, d in enumerate(devs)))


def _wire_sizes(B: int, F: int, Lr: int, Lw: int, Ld: int,
                channels: int) -> list[int]:
    Ls = F * channels
    return ([B, B] + [Lr] * 6 + [Lw] * 6 + [Ld] * 3 + [Ls] * 4
            + [Ls * 32] + [F] * 5)


def flac_decode_wire(bytes_u8, desc, *, channels: int, nmax: int, smax: int,
                     rice_steps: int, fw_imax: int, rice_narrow: bool,
                     B: int, F: int, Lr: int, Lw: int, Ld: int,
                     stage: str = "full"):
    """Two-transfer entry: ``flac_decode_batch`` with every descriptor in
    ONE int32 tensor (decoder.pack_wire's layout); the last field is the
    f32 frame scale, carried as its int32 bit pattern."""
    parts = list(torch.split(desc, _wire_sizes(B, F, Lr, Lw, Ld, channels)))
    parts[21] = parts[21].reshape(F * channels, 32)
    parts[26] = parts[26].contiguous().view(torch.float32)
    return flac_decode_batch(
        bytes_u8, *parts, channels=channels, nmax=nmax, smax=smax,
        rice_steps=rice_steps, fw_imax=fw_imax, rice_narrow=rice_narrow,
        stage=stage)
