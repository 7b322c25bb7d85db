"""Wrapper of the CUDA entropy-scan kernel (``csrc/mp3_entropy.cu``).

``entropy_scan`` is the port of the JAX package's Pallas scan
(``codecs/mpeg/huffman_pallas.py::entropy_scan``).  For CUDA tensors it
launches the hand-written kernel (built with nvcc for sm_90a at first use)
on the current stream, without synchronising; for CPU tensors it runs the
plain torch twin ``huffman_device.scan_plain``.  Any other device raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes as C

import torch

from ...utils import build
from . import huffman_device as HD

#: number of times the CUDA kernel was launched in this process
launches = 0

_LANE_ARGS = ("file_idx", "start_bit", "end_bit", "limit_bit", "big_values",
              "region1", "region2", "c1sel", "valid")


def _declare(lib: C.CDLL) -> None:
    fn = lib.mp3_entropy_scan
    p, i = C.c_void_p, C.c_int
    fn.argtypes = [p, i, i] + [p] * 10 + [p] * 7 + [i] * 3 + [p] * 4
    fn.restype = C.c_int


def load_library() -> C.CDLL:
    """Build (first use) and load the kernel library."""
    return build.load_cuda_kernels("mp3_entropy", _declare)


def _check_lanes(main_u8, lanes: dict, tsel) -> int:
    if main_u8.dtype != torch.uint8 or main_u8.dim() != 2:
        raise ValueError(f"main_u8 must be uint8 [B, M], got {main_u8.dtype} "
                         f"{tuple(main_u8.shape)}")
    n = lanes["start_bit"].shape[0]
    for name, t in lanes.items():
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tsel.dtype != torch.int32 or tuple(tsel.shape) != (n, 3):
        raise ValueError(f"tsel must be int32 [{n}, 3], got {tsel.dtype} "
                         f"{tuple(tsel.shape)}")
    for t in (main_u8, tsel, *lanes.values()):
        if t.device != main_u8.device:
            raise ValueError("entropy_scan inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("entropy_scan inputs must be contiguous")
    return n


def _scan_cuda(main_u8, lanes: dict, tsel, n_big: int, n_c1: int):
    global launches
    n = _check_lanes(main_u8, lanes, tsel)
    lib = load_library()
    dev = main_u8.device
    tb = HD.device_tables(dev)
    big576 = torch.empty((n, 576), dtype=torch.int16, device=dev)
    c1 = torch.empty((n, 144, 4), dtype=torch.int16, device=dev)
    fail = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # launch on the tensors' card
        rc = lib.mp3_entropy_scan(
            main_u8.data_ptr(), main_u8.shape[0], main_u8.shape[1],
            *[lanes[k].data_ptr() for k in _LANE_ARGS[:7]], tsel.data_ptr(),
            lanes["c1sel"].data_ptr(), lanes["valid"].data_ptr(),
            tb["lut2"].data_ptr(), tb["l1_base"].data_ptr(),
            tb["c1lut"].data_ptr(), tb["big_width"].data_ptr(),
            tb["ktid"].data_ptr(), tb["klin"].data_ptr(), tb["kres"].data_ptr(),
            n, min(max(n_big, 1), 512), HD.count1_quads(n_c1),
            big576.data_ptr(), c1.data_ptr(), fail.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"mp3_entropy_scan launch failed: CUDA error {rc}")
    launches += 1
    return big576, c1, fail


def entropy_scan(main_u8, file_idx, start_bit, end_bit, limit_bit, big_values,
                 region1, region2, tsel, c1sel, valid, *, n_big: int = 512,
                 n_c1: int = 144):
    """Huffman-scan every lane → (big576 i16 [N, 576], c1 i16 [N, 144, 4],
    fail bool [N]); see huffman_device.scan_plain for the contract."""
    dev = main_u8.device
    if dev.type == "cpu":
        return HD.scan_plain(
            main_u8, file_idx, start_bit, end_bit, limit_bit, big_values,
            region1, region2, tsel, c1sel, valid, n_big=n_big, n_c1=n_c1)
    if dev.type != "cuda":
        raise ValueError(f"entropy_scan: unsupported device {dev}")
    lanes = dict(zip(_LANE_ARGS, (file_idx, start_bit, end_bit, limit_bit,
                                  big_values, region1, region2, c1sel, valid)))
    return _scan_cuda(main_u8, lanes, tsel, n_big, n_c1)
