"""Polyphase synthesis filterbank: CUDA kernel wrapper and plain twin.

``polyphase_synthesis_blocks(TS, n_mat, g2)`` maps subband samples
``f32 [BC, T, 32]`` to PCM blocks ``f32 [BC, T, 32]``: per row, a 32→64
matrixing by ``n_mat`` (tables.SYNTH_N) and a 16-tap FIR with ``g2``
(dsp._G2) over a zero-started history.  It is the port of the JAX
package's Pallas kernel ``ops/pallas_synth.py::polyphase_synthesis_pallas``.

For CUDA tensors it launches ``csrc/mp3_synth.cu`` (built with nvcc for
sm_90a at first use) on the current stream, without synchronising; for
CPU tensors it runs ``synthesis_plain``, the JAX package's XLA form.  Any
other device raises.  ``launches`` counts kernel launches.

The kernel multiplies by ``fold_synth_n(n_mat)``: the 32 distinct rows of
SYNTH_N, folded over their symmetry in k, which the wrapper builds once
per ``n_mat`` tensor (and refuses for a matrix without that symmetry).
"""

from __future__ import annotations

import ctypes as C
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import build
from ..utils.trace import to_device, to_host

#: number of times the CUDA kernel was launched in this process
launches = 0

#: SYNTH_N rows behind the folded matrix's 32 rows (csrc/mp3_synth.cu
#: vcol): A0,A2..A14 = rows 0,2..14; B0,B2..B14 = rows 32,34..46; then the
#: odd ones, A1..A15 = rows 1,3..15 and B1..B15 = rows 33,35..47
FOLD_ROWS = np.concatenate([np.arange(0, 16, 2), np.arange(32, 48, 2),
                            np.arange(1, 16, 2), np.arange(33, 48, 2)])
#: |N[16, k]| below this is dropped as zero (SYNTH_N's is 8.8e-15 at most)
ROW16_TOL = 1e-12

#: id(n_mat) -> (weak reference to n_mat, its version, folded matrix)
_FOLDED: dict = {}


def _declare(lib: C.CDLL) -> None:
    fn = lib.mp3_synth
    fn.argtypes = [C.c_void_p] * 4 + [C.c_int, C.c_int, C.c_void_p]
    fn.restype = C.c_int


def load_library() -> C.CDLL:
    """Build (first use) and load the kernel library."""
    return build.load_cuda_kernels("mp3_synth", _declare)


def synthesis_plain(TS: torch.Tensor, n_mat: torch.Tensor,
                    g2: torch.Tensor) -> torch.Tensor:
    """Plain torch synthesis: materialize V = TS @ n_mat^T for every step,
    then sum 16 shifted half-views of it (f32 throughout)."""
    BC, T, _ = TS.shape
    V = torch.matmul(TS, n_mat.t())                     # [BC, T, 64]
    Vp = F.pad(V, (0, 0, 15, 0))                        # V[t < 0] = 0
    out = torch.zeros((BC, T, 32), dtype=torch.float32, device=TS.device)
    for k in range(16):
        seg = Vp[:, 15 - k: 15 - k + T]
        half = seg[..., :32] if k % 2 == 0 else seg[..., 32:]
        out = out + g2[k] * half
    return out


def fold_synth_n(n_mat) -> np.ndarray:
    """The folded matrix f32 [32, 16] of a 64 x 32 matrixing with SYNTH_N's
    symmetry: row ``r`` is ``n_mat[FOLD_ROWS[r], :16]``.

    The kernel relies on (and this checks, exactly in f32): rows 17..31
    are -rows 15..1, rows 49..63 are rows 47..33, row 48 is -1, row 16 is
    below ROW16_TOL (and taken as 0), and every other row n has
    ``N[n, 31-k] == (-1)^n N[n, k]``."""
    n = np.asarray(n_mat, np.float32)
    if n.shape != (64, 32):
        raise ValueError(f"n_mat must be (64, 32), got {n.shape}")
    i = np.arange(1, 16)
    kept = np.r_[0:16, 32:48]
    sign = np.where(kept % 2 == 0, 1.0, -1.0).astype(np.float32)[:, None]
    if not (np.array_equal(n[32 - i], -n[i])
            and np.array_equal(n[64 - i], n[32 + i])
            and np.all(n[48] == -1.0)
            and np.all(np.abs(n[16]) < ROW16_TOL)
            and np.array_equal(n[kept][:, ::-1], sign * n[kept])):
        raise ValueError("n_mat lacks SYNTH_N's symmetry, which the kernel "
                         "folds")
    return np.ascontiguousarray(n[FOLD_ROWS, :16])


def _folded(n_mat: torch.Tensor) -> torch.Tensor:
    """fold_synth_n of ``n_mat`` on its device, cached per tensor version
    (the first call for a tensor copies it to the host once)."""
    hit = _FOLDED.get(id(n_mat))
    if hit is not None and hit[0]() is n_mat and hit[1] == n_mat._version:
        return hit[2]
    nf = to_device(fold_synth_n(to_host(n_mat)), n_mat.device)
    key = id(n_mat)
    _FOLDED[key] = (weakref.ref(n_mat, lambda _r: _FOLDED.pop(key, None)),
                    n_mat._version, nf)
    return nf


def _synthesis_cuda(TS, n_mat, g2):
    global launches
    for name, t, shape in (("TS", TS, None), ("n_mat", n_mat, (64, 32)),
                           ("g2", g2, (16, 32))):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != TS.device:
            raise ValueError("polyphase synthesis inputs must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if TS.dim() != 3 or TS.shape[2] != 32:
        raise ValueError(f"TS must be [BC, T, 32], got {tuple(TS.shape)}")
    lib = load_library()
    nf = _folded(n_mat)
    if TS.data_ptr() % 16:  # the kernel reads 16-byte words
        TS = TS.clone()
    BC, T, _ = TS.shape
    out = torch.empty_like(TS)
    stream = torch.cuda.current_stream(TS.device).cuda_stream
    with torch.cuda.device(TS.device):  # launch on the tensors' card
        rc = lib.mp3_synth(TS.data_ptr(), nf.data_ptr(), g2.data_ptr(),
                           out.data_ptr(), BC, T, stream)
    if rc != 0:
        raise RuntimeError(f"mp3_synth launch failed: CUDA error {rc}")
    launches += 1
    return out


def polyphase_synthesis_blocks(TS: torch.Tensor, n_mat: torch.Tensor,
                               g2: torch.Tensor) -> torch.Tensor:
    """TS f32 [BC, T, 32] → PCM blocks f32 [BC, T, 32]."""
    dev = TS.device
    if dev.type == "cpu":
        return synthesis_plain(TS, n_mat, g2)
    if dev.type != "cuda":
        raise ValueError(f"polyphase synthesis: unsupported device {dev}")
    return _synthesis_cuda(TS, n_mat, g2)
