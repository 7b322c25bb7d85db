"""ctypes binding to the native flacfe FLAC front-end.

The C++ library is compiled from the port's copy of the source,
``native/flacfe.cc``, into the port's build directory (utils/build.py).
It implements the FLAC structural walk (whole files, threaded), the hot
inner loops of the Python walk (rice-run skipping, frame CRC-8/16) and
the int64 host decode of 26-32-bit streams.  There is no pure-Python
fallback for a missing library: if it cannot be built, every entry point
raises ``BuildError``.  ``skip_rice`` still returns None for the calls
whose end-of-stream semantics the Python walk decides (frontend._Bits).
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

from ...utils import build

_SRC = os.path.join(build.NATIVE_DIR, "flacfe.cc")

#: outlier-triple capacity per skip_rice call — quotients past Q_CAP are
#: rare encoder pathologies; a partition has < 2^16 codes, and a stream
#: dense in outliers re-walks via the Python path
_OUT_CAP = 4096

#: the per-file fields of a walk, in flacfe_walk_fill's argument order
_FIELDS = ("blocksizes", "starts", "ch_mode", "byte_offs",
           "sub_frame", "sub_ch", "sub_kind", "sub_order",
           "sub_shift", "sub_wasted", "sub_coeffs",
           "rl_sub", "rl_bitpos", "rl_count", "rl_param", "rl_dest",
           "fw_sub", "fw_bitpos", "fw_count", "fw_width", "fw_dest",
           "dv_sub", "dv_dest", "dv_val")


def _build() -> str:
    if not os.path.exists(_SRC):
        raise build.BuildError(f"flacfe source missing: {_SRC}")
    return build.build_shared("flacfe", "g++", build.GXX_FLAGS, [_SRC])


def _declare(lib: C.CDLL) -> None:
    lib.flacfe_skip_rice.restype = C.c_int64
    lib.flacfe_skip_rice.argtypes = [
        C.c_char_p, C.c_int64, C.c_int64, C.c_int64, C.c_int32,
        C.c_int32, C.POINTER(C.c_int64), C.c_int64,
        C.POINTER(C.c_int64), C.c_int64, C.POINTER(C.c_int64),
    ]
    lib.flacfe_crc8.restype = C.c_uint32
    lib.flacfe_crc8.argtypes = [C.c_char_p, C.c_int64]
    lib.flacfe_crc16.restype = C.c_uint32
    lib.flacfe_crc16.argtypes = [C.c_char_p, C.c_int64]
    lib.flacfe_walk_open.restype = C.c_void_p
    lib.flacfe_walk_open.argtypes = [
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64), C.c_int32,
        C.c_int32, C.c_int64, C.c_int32, C.c_int64, C.c_int32,
    ]
    lib.flacfe_walk_info.restype = None
    lib.flacfe_walk_info.argtypes = [
        C.c_void_p, C.POINTER(C.c_int64), C.POINTER(C.c_uint8)]
    lib.flacfe_walk_fill.restype = None
    lib.flacfe_walk_fill.argtypes = [C.c_void_p, C.c_int32] + (
        [C.c_void_p] * len(_FIELDS))
    lib.flacfe_walk_free.restype = None
    lib.flacfe_walk_free.argtypes = [C.c_void_p]
    lib.flacfe_walks.restype = C.c_int64
    lib.flacfe_walks.argtypes = []
    lib.flacfe_decode.restype = C.c_int64
    lib.flacfe_decode.argtypes = [
        C.c_char_p, C.c_int64, C.POINTER(C.c_int32), C.c_int64,
        C.POINTER(C.c_int64),
    ]


def _load() -> C.CDLL:
    return build.load_library("flacfe", _build, _declare)


def skip_rice(blob: bytes, nbits: int, pos: int, count: int,
              param: int, q_cap: int, split: int = 0,
              ) -> tuple[int, list, np.ndarray] | None:
    """(new_pos, outlier triples, split bit positions) — or None when the
    call crosses the end of the stream or overflows the outlier buffer, in
    which case the caller walks it in Python, whose error taxonomy is the
    contract.  With ``split`` > 0, entry k of the positions array is the
    bit cursor before code (k+1)*split — the lane-cut points."""
    lib = _load()
    out = np.empty((_OUT_CAP, 3), np.int64)
    scap = (count - 1) // split if split > 0 else 0
    splits = np.empty((max(scap, 1),), np.int64)
    n_out = C.c_int64(0)
    new_pos = lib.flacfe_skip_rice(
        blob, nbits, pos, count, param, q_cap,
        out.ctypes.data_as(C.POINTER(C.c_int64)), _OUT_CAP,
        C.byref(n_out), split,
        splits.ctypes.data_as(C.POINTER(C.c_int64)),
    )
    if new_pos < 0:
        return None
    triples = [(int(a), int(b), int(c)) for a, b, c in out[: n_out.value]]
    return int(new_pos), triples, splits[:scap]


def walks() -> int:
    """Cumulative native whole-file walks (test pin counter)."""
    return int(_load().flacfe_walks())


def walk_batch(blobs: list[bytes], q_cap: int, split: int, max_bps: int,
               bit_cap: int) -> list[dict | int]:
    """Whole-file walks of a batch, threaded in C — one dict of
    FlacAnalysis fields per clean file, the walker's int error code
    (core.errors ERR_*) per rejected file (the caller re-walks those in
    Python so its exception taxonomy/messages stay authoritative)."""
    lib = _load()
    if not blobs:
        return []
    n = len(blobs)
    blobs = [bytes(b) for b in blobs]
    arr = (C.c_char_p * n)(*blobs)
    lens = (C.c_int64 * n)(*[len(b) for b in blobs])
    sess = lib.flacfe_walk_open(arr, lens, n, q_cap, split, max_bps,
                                bit_cap, 0)
    try:
        info = np.zeros((n, 12), np.int64)
        md5 = np.zeros((n, 16), np.uint8)
        lib.flacfe_walk_info(
            sess, info.ctypes.data_as(C.POINTER(C.c_int64)),
            md5.ctypes.data_as(C.POINTER(C.c_uint8)))
        out: list[dict | int] = []
        for i in range(n):
            err, rate, ch, bits, total, got, _fs, F, S, R, W, D = (
                int(v) for v in info[i])
            if err:
                out.append(err)
                continue
            d = dict(
                sample_rate=rate, channels=ch, bits=bits,
                total=total or got, md5=md5[i].tobytes(),
                blocksizes=np.empty(F, np.int32),
                starts=np.empty(F, np.int64),
                ch_mode=np.empty(F, np.int32),
                byte_offs=np.empty(F + 1, np.int64),
                sub_frame=np.empty(S, np.int32),
                sub_ch=np.empty(S, np.int32),
                sub_kind=np.empty(S, np.int32),
                sub_order=np.empty(S, np.int32),
                sub_shift=np.empty(S, np.int32),
                sub_wasted=np.empty(S, np.int32),
                sub_coeffs=np.empty((S, 32), np.int32),
                rl_sub=np.empty(R, np.int32),
                rl_bitpos=np.empty(R, np.int64),
                rl_count=np.empty(R, np.int32),
                rl_param=np.empty(R, np.int32),
                rl_dest=np.empty(R, np.int32),
                fw_sub=np.empty(W, np.int32),
                fw_bitpos=np.empty(W, np.int64),
                fw_count=np.empty(W, np.int32),
                fw_width=np.empty(W, np.int32),
                fw_dest=np.empty(W, np.int32),
                dv_sub=np.empty(D, np.int32),
                dv_dest=np.empty(D, np.int32),
                dv_val=np.empty(D, np.int32),
            )
            lib.flacfe_walk_fill(
                sess, i, *(d[k].ctypes.data_as(C.c_void_p) for k in _FIELDS))
            out.append(d)
        return out
    finally:
        lib.flacfe_walk_free(sess)


def crc8(data) -> int:
    b = bytes(data)
    return int(_load().flacfe_crc8(b, len(b)))


def crc16(data) -> int:
    b = bytes(data)
    return int(_load().flacfe_crc16(b, len(b)))
