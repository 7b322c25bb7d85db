"""FLAC's predictor reconstruction on the card: the wrapper of
``csrc/flac_predict.cu``.

``predict_cuda(vals, kind, order, shift, wasted, coeffs)`` reconstructs
every subframe's samples in one launch and returns them as int32
``[Ls, nmax]``, contiguous: the samples of the plain twin
``codecs/flac/device.py::_predict``, bit for bit.  ``vals`` is int32
``[Ls, nmax]`` (warm-up samples, then residuals) with unit inner stride and
any row stride of at least ``nmax``: the decode hands over its view of the
flat values (rows ``nmax + 1`` apart) and nothing is copied.  ``kind``,
``order``, ``shift`` and ``wasted`` are int32 ``[Ls]`` and ``coeffs``
int32 ``[Ls, 32]``.  The kernel holds to the contract the FLAC front-end
guarantees: order 0-32, shift 0-15, coefficients zero past the order and
under 2^15 in magnitude.  The kernel has no TPU counterpart: the JAX
package's recurrence is a ``lax.scan``, which XLA fuses; on the card the
twin's loop of small torch ops is launch-bound.

The library is built with nvcc for sm_90a at first use; the launch runs
on the current stream without synchronising.  Inputs are checked, and
must be CUDA tensors, before the library loads; a failed launch raises,
nothing falls back.  ``launches["flac_predict"]`` counts launches, and each
adds its subframes to the tracer's ``flac.predict_kernel`` counter.
"""

from __future__ import annotations

import ctypes as C

import torch

from ..utils import build
from ..utils.trace import TRACE

#: times the kernel was launched in this process
launches = {"flac_predict": 0}


def _declare(lib: C.CDLL) -> None:
    p, i, ll = C.c_void_p, C.c_int, C.c_longlong
    lib.flac_predict_launch.restype = i
    lib.flac_predict_launch.argtypes = [p, ll, p, p, p, p, p, i, i, p, p]


def load_library() -> C.CDLL:
    """Build (first use) and load the predictor's kernel library."""
    return build.load_cuda_kernels("flac_predict", _declare)


def _check(vals, kind, order, shift, wasted, coeffs) -> None:
    if vals.dtype != torch.int32 or vals.dim() != 2:
        raise ValueError(f"predict: vals must be int32 [Ls, nmax], got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    Ls, nmax = vals.shape
    if nmax > 1 and vals.stride(1) != 1:
        raise ValueError(f"predict: vals must have unit inner stride, got "
                         f"strides {vals.stride()}")
    if Ls > 1 and vals.stride(0) < nmax:
        raise ValueError(f"predict: vals' row stride {vals.stride(0)} is "
                         f"under nmax {nmax}: its rows overlap")
    for name, t in (("kind", kind), ("order", order), ("shift", shift),
                    ("wasted", wasted)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != Ls:
            raise ValueError(f"predict: {name} must be int32 [Ls] with vals' "
                             f"Ls {Ls}, got {t.dtype} {tuple(t.shape)}")
    if coeffs.dtype != torch.int32 or tuple(coeffs.shape) != (Ls, 32):
        raise ValueError(f"predict: coeffs must be int32 [Ls, 32] with vals' "
                         f"Ls {Ls}, got {coeffs.dtype} {tuple(coeffs.shape)}")
    for t in (kind, order, shift, wasted, coeffs):
        if t.device != vals.device:
            raise ValueError("predict: inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("predict: the subframe arrays must be contiguous")
    if Ls >= 2**31 or nmax >= 2**31:
        raise ValueError(f"predict: [{Ls}, {nmax}] is past int32 sizes")


def predict_cuda(vals, kind, order, shift, wasted, coeffs, lib=None,
                 cuda_stream=None):
    """Launch ``csrc/flac_predict.cu`` on CUDA tensors (or ``lib``, a library
    with its interface, on tensors of any device) on ``cuda_stream``
    (default: the current one) → samples int32 ``[Ls, nmax]``."""
    _check(vals, kind, order, shift, wasted, coeffs)
    dev = vals.device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"predict: the kernel takes CUDA tensors, got {dev}")
    lib = lib or load_library()
    Ls, nmax = vals.shape
    out = torch.empty((Ls, nmax), dtype=torch.int32, device=dev)
    if cuda_stream is None:
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    # a ctypes launch runs on the current card (-1, a no-op, for the host
    # tensors that a stand-in ``lib`` takes)
    with torch.cuda.device(dev if dev.type == "cuda" else -1):
        rc = lib.flac_predict_launch(
            vals.data_ptr(), vals.stride(0), kind.data_ptr(),
            order.data_ptr(), shift.data_ptr(), wasted.data_ptr(),
            coeffs.data_ptr(), Ls, nmax, out.data_ptr(), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flac_predict launch failed: CUDA error {rc}")
    launches["flac_predict"] += 1
    TRACE.count("flac.predict_kernel", Ls)
    return out
