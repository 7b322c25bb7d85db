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
"""

from __future__ import annotations

import ctypes as C

import torch
import torch.nn.functional as F

from ..utils import build

#: number of times the CUDA kernel was launched in this process
launches = 0


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
    BC, T, _ = TS.shape
    out = torch.empty_like(TS)
    stream = torch.cuda.current_stream(TS.device).cuda_stream
    rc = lib.mp3_synth(TS.data_ptr(), n_mat.data_ptr(), g2.data_ptr(),
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
