"""FLAC's rice lane scan on the card: the wrapper of ``csrc/flac_rice.cu``.

``rice_scan_cuda(stream, bitpos, count, param, limit, steps, narrow,
codes_per_step, q_cap)`` decodes ``steps * codes_per_step`` rice codes of
every lane in one launch and returns (values int32 ``[L, steps*K]``, ovf
bool ``[L]``): the values of the plain twin
``codecs/flac/device.py::_rice_scan``, bit for bit, with the codes at or
past each lane's ``count`` written as 0 (the mask the decode applies to
the twin's values).  The caller gives the variant's codes per step and the
quotient cap; the kernel has the variant's count compiled in and refuses
another.  The kernel has no TPU counterpart: the JAX package's scan is a
``lax.scan``, which XLA fuses; on the card the twin's loop of small torch
ops is launch-bound.

The library is built with nvcc for sm_90a at first use; the launch runs
on the current stream without synchronising.  Inputs are checked, and
must be CUDA tensors, before the library loads; a failed launch raises,
nothing falls back.  ``launches["flac_rice"]`` counts launches, and each
adds its lanes to the tracer's ``flac.rice_kernel`` counter.
"""

from __future__ import annotations

import ctypes as C

import torch

from ..utils import build
from ..utils.trace import TRACE

#: times the kernel was launched in this process
launches = {"flac_rice": 0}


def _declare(lib: C.CDLL) -> None:
    p, i, ll = C.c_void_p, C.c_int, C.c_longlong
    lib.flac_rice_scan_launch.restype = i
    lib.flac_rice_scan_launch.argtypes = [p, ll, p, p, p, p, i, i, i, i, i,
                                          p, p, p]


def load_library() -> C.CDLL:
    """Build (first use) and load the rice scan's kernel library."""
    return build.load_cuda_kernels("flac_rice", _declare)


def _check(stream, bitpos, count, param, limit, steps: int,
           codes_per_step: int, q_cap: int) -> None:
    if stream.dtype != torch.uint8 or stream.dim() != 1:
        raise ValueError(f"rice_scan: stream must be uint8 [N], got "
                         f"{stream.dtype} {tuple(stream.shape)}")
    L = bitpos.shape[0] if bitpos.dim() == 1 else -1
    for name, t, dtype in (("bitpos", bitpos, torch.int32),
                           ("count", count, torch.int32),
                           ("param", param, torch.int32),
                           ("limit", limit, torch.int64)):
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != L:
            raise ValueError(f"rice_scan: {name} must be {dtype} [L] with one "
                             f"L for every lane array, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (stream, bitpos, count, param, limit):
        if t.device != stream.device:
            raise ValueError("rice_scan: inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("rice_scan: inputs must be contiguous")
    if not 0 <= steps < 2**27:
        raise ValueError(f"rice_scan: steps must be in [0, 2^27), got {steps}")
    if not (1 <= codes_per_step <= 8 and 0 <= q_cap <= 32):
        raise ValueError(f"rice_scan: codes per step {codes_per_step} or "
                         f"q_cap {q_cap} out of range")


def rice_scan_cuda(stream, bitpos, count, param, limit, steps: int,
                   narrow: bool, codes_per_step: int, q_cap: int, lib=None,
                   cuda_stream=None):
    """Launch ``csrc/flac_rice.cu`` on CUDA tensors (or ``lib``, a library
    with its interface, on tensors of any device) on ``cuda_stream``
    (default: the current one) → (values int32 ``[L, steps*K]``, zero past
    ``count``; ovf bool ``[L]``)."""
    _check(stream, bitpos, count, param, limit, steps, codes_per_step, q_cap)
    dev = stream.device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"rice_scan: the kernel takes CUDA tensors, got {dev}")
    lib = lib or load_library()
    L = bitpos.shape[0]
    W = steps * codes_per_step
    out = torch.empty((L, W), dtype=torch.int32, device=dev)
    ovf = torch.empty((L,), dtype=torch.bool, device=dev)
    if cuda_stream is None:
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    # a ctypes launch runs on the current card (-1, a no-op, for the host
    # tensors that a stand-in ``lib`` takes)
    with torch.cuda.device(dev if dev.type == "cuda" else -1):
        rc = lib.flac_rice_scan_launch(
            stream.data_ptr(), stream.shape[0], bitpos.data_ptr(),
            count.data_ptr(), param.data_ptr(), limit.data_ptr(), L, W,
            int(narrow), codes_per_step, q_cap, out.data_ptr(),
            ovf.data_ptr(), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flac_rice launch failed: CUDA error {rc}")
    launches["flac_rice"] += 1
    TRACE.count("flac.rice_kernel", L)
    return out, ovf
