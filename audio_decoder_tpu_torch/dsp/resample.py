"""Rational polyphase resampling as one batched f32 product.

The reference's only resampling is per-voice fractional-position linear
interpolation in the render loop (engine.rs:429-438).  Batch decode needs
real consensus-rate conversion (main.rs:91-105 picks a consensus rate but
the reference never converts); here it is a windowed-sinc polyphase
resampler:

For a rational ratio ``dst/src = L/M`` (reduced), every block of L output
samples is a linear function of one window of ``M + K`` input samples, so
the whole resample is

    patches [B, F, (M+K)·C]  @  Wf [(M+K)·C, L·C]  →  y [B, F, L·C]

— one batched product, no sequential state.  Wf folds the Kaiser-windowed
sinc interpolation filter at each of the L phases, expanded
channel-block-diagonal so the whole pipeline runs on the flat interleaved
``[B, S*C]`` layout (AudioBatch.data).  The patches are the overlapping
frame windows of the padded rows (``Tensor.unfold``), made contiguous by
the product.  The product runs in full f32: the package turns TF32 off at
import.

It is the port of the JAX package's ``dsp/resample.py``; ``_poly_matrix``,
``_ratio`` and ``_poly_matrix_flat`` are verbatim copies (numpy only).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

#: filter half-width per phase (taps per output sample)
_TAPS = 32


@functools.lru_cache(maxsize=64)
def _poly_matrix(L: int, M: int, taps: int = _TAPS) -> np.ndarray:
    """[L, M + taps] polyphase weight matrix for dst/src = L/M.

    Output sample j of a frame sits at input time ``j*M/L`` (relative to
    the frame's first input sample); its value is a Kaiser-windowed sinc
    interpolation over `taps` neighbouring inputs, lowpassed to the
    narrower of the two Nyquists (cutoff min(1, L/M) of input Nyquist).
    """
    W = np.zeros((L, M + taps))
    cutoff = min(1.0, L / M)
    beta = 8.6  # Kaiser beta ≈ 90 dB stopband
    half = taps // 2
    for j in range(L):
        t = j * M / L  # fractional input position
        base = math.floor(t)
        frac = t - base
        for k in range(taps):
            # input index: base + k - half + 1 … window centred on t
            n = k - half + 1 - frac
            x = cutoff * n
            sinc = cutoff * (np.sinc(x))
            w = n / half
            win = np.i0(beta * np.sqrt(max(0.0, 1 - w * w))) / np.i0(beta)
            idx = base + k - half + 1 + half  # shift so indices start at 0
            if 0 <= idx < M + taps:
                W[j, idx] += sinc * win
    return W.astype(np.float32)


def _ratio(src: int, dst: int) -> tuple[int, int]:
    g = math.gcd(src, dst)
    return dst // g, src // g  # L (up), M (down)


@functools.lru_cache(maxsize=64)
def _poly_matrix_flat(L: int, M: int, C: int, taps: int = _TAPS) -> np.ndarray:
    """[(M+taps)*C, L*C] channel-block-diagonal polyphase matrix.

    The flat-interleaved kernel contracts the whole (window x channel)
    axis at once; expanding W so ``Wf[k*C+c, j*C+c] = W[j, k]`` keeps
    channels independent.  The off-channel zeros cost Cx MXU FLOPs —
    noise next to the 64-128x HBM tile-padding tax a trailing C dim of
    1-2 would impose on the patches tensor (core/batch.py docstring)."""
    W = _poly_matrix(L, M, taps)  # [L, M+taps]
    K = M + taps
    Wf = np.zeros((K * C, L * C), np.float32)
    for c in range(C):
        Wf[c::C, c::C] = W.T
    return Wf


@functools.lru_cache(maxsize=64)
def _wf_tensor(L: int, M: int, C: int, device: torch.device) -> torch.Tensor:
    """``_poly_matrix_flat`` as a tensor on ``device``, made once."""
    return torch.as_tensor(_poly_matrix_flat(L, M, C), device=device)


def _resample_LM_flat(data: torch.Tensor, *, L: int, M: int, C: int
                      ) -> torch.Tensor:
    """Flat interleaved [B, S*C] → [B, (S//M)*L*C] on ``data``'s device."""
    B, SC = data.shape
    S = SC // C
    half = _TAPS // 2
    # pad so every frame window [f*M - half + 1, f*M + M + half] is valid
    xp = F.pad(data, (half * C, (M + half) * C))
    n_frames = S // M
    patches = xp.unfold(1, (M + _TAPS) * C, M * C)[:, :n_frames]
    y = torch.matmul(patches, _wf_tensor(L, M, C, data.device))  # [B, F, L*C]
    return y.reshape(B, n_frames * L * C)


def _resample_LM(pcm: torch.Tensor, *, L: int, M: int) -> torch.Tensor:
    """Planar [B, S, C] → [B, S*L//M (frame-truncated), C] (convenience
    wrapper over the flat form)."""
    B, S, C = pcm.shape
    y = _resample_LM_flat(pcm.reshape(B, S * C), L=L, M=M, C=C)
    return y.reshape(B, -1, C)


def resample_batch(pcm, src_rate: int, dst_rate: int, *,
                   device="cuda") -> torch.Tensor:
    """Resample a [B, S, C] batch from src_rate to dst_rate on ``device``.

    Identity when the rates match.  Output length is ``floor(S/M)*L``
    (whole polyphase frames)."""
    from ..codecs.registry import resolve_device

    pcm = torch.as_tensor(pcm, device=resolve_device(device))
    if src_rate == dst_rate:
        return pcm
    L, M = _ratio(src_rate, dst_rate)
    return _resample_LM(pcm, L=L, M=M)


def resample_to_consensus(batch, consensus_rate: int, length: str = "floor",
                          *, device="cuda"):
    """Resample every file in an AudioBatch to the consensus rate, on
    ``device``.

    Files are grouped by source rate (one product per distinct ratio);
    returns a new AudioBatch at the uniform rate, with valid_frames
    rescaled.  Mirrors the *intent* of the reference's consensus config
    (main.rs:91-120) — the reference picks a consensus rate but plays
    mismatched files unconverted.

    length: per-file valid-length policy.  "floor" (default) keeps whole
    polyphase frames — floor(valid/M)*L samples; "exact" reports
    ceil(valid*L/M), the sample-exact duration, clamped to the rendered
    frames (the final partial frame is zero-padded by the kernel).
    """
    if length not in ("floor", "exact"):
        raise ValueError(f"length policy {length!r} (want floor|exact)")
    from ..codecs.registry import resolve_device
    from ..core.batch import AudioBatch

    dev = resolve_device(device)
    rates = batch.sample_rate.cpu().numpy()
    valid = batch.valid_frames.cpu().numpy()
    err = batch.err.cpu().numpy()
    B = batch.batch_size
    S = batch.max_frames
    C = batch.channels
    uniq = sorted({int(r) for r, e in zip(rates, err) if e == 0 and r > 0})
    meta = dict(sample_rate=batch.sample_rate.to(dev),
                num_channels=batch.num_channels.to(dev),
                bits_per_sample=batch.bits_per_sample.to(dev),
                valid_frames=batch.valid_frames.to(dev),
                err=batch.err.to(dev))
    if uniq in ([], [int(consensus_rate)]):
        return AudioBatch(data=batch.data.to(dev), channels=C,
                          names=batch.names, formats=batch.formats, **meta)

    max_out = 1
    plans = {}
    for r in uniq:
        L, M = _ratio(r, int(consensus_rate)) if r != consensus_rate else (1, 1)
        out_len = (S // M) * L
        plans[r] = (L, M, out_len)
        max_out = max(max_out, out_len)

    # everything stays flat interleaved [B, S*C] end to end
    data = batch.data.to(dev)
    data_out = torch.zeros((B, max_out * C), dtype=torch.float32, device=dev)
    new_valid = valid.copy()
    for r in uniq:
        L, M, out_len = plans[r]
        rows = np.nonzero((rates == r) & (err == 0))[0]
        sel = torch.as_tensor(rows, device=dev)
        if r == int(consensus_rate):
            piece = data[sel]
            out_len = S
        else:
            piece = _resample_LM_flat(data[sel], L=L, M=M, C=C)
        data_out[sel, : out_len * C] = piece[:, : out_len * C]
        if length == "exact" and r != int(consensus_rate):
            new_valid[rows] = np.minimum(
                -(-valid[rows] * L // M), out_len
            )
        else:
            new_valid[rows] = (valid[rows] // M) * L
    ok = meta["err"] == 0
    meta["sample_rate"] = torch.where(
        ok, torch.tensor(int(consensus_rate), dtype=meta["sample_rate"].dtype,
                         device=dev), meta["sample_rate"])
    meta["valid_frames"] = torch.as_tensor(new_valid, device=dev)
    return AudioBatch(data=data_out, channels=C, names=batch.names,
                      formats=batch.formats, **meta)
