"""ctypes binding to the native mp3fe bitstream front-end.

The C++ library is compiled from the port's copy of the source,
``native/mp3fe.cc``, into the port's build directory (utils/build.py),
with its Huffman tables header generated there first (utils/gen_luts.py).
There is no pure-Python fallback: if the library cannot be built, every
entry point raises ``BuildError``.

* ``available()`` — whether the library could be built and loaded;
* ``probe(blob)`` — cheap geometry walk (sr, channels, granules, joint);
* ``analyze_batch(blobs, g_cap, channels, joint)`` — threaded batch
  analysis (the Huffman decode on the host) straight into the padded
  [B, G, ...] arrays the DSP tail eats;
* ``frame_walks()`` — the process-wide count of native frame walks;
* ``lanes_batch(blobs, g_cap, m_cap, channels)`` — raw main_data plus
  per-lane side metadata for the on-device Huffman path;
* ``Mp3Session`` — one frame walk per blob serving layer routing,
  grouping probes and lane emission.
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

from ...utils import build, gen_luts

_SRC = os.path.join(build.NATIVE_DIR, "mp3fe.cc")


class _Info(C.Structure):
    _fields_ = [
        ("sample_rate", C.c_int32),
        ("channels", C.c_int32),
        ("n_granules", C.c_int32),
        ("joint", C.c_int32),
        ("err", C.c_int32),
        ("main_bytes", C.c_int32),
    ]


_LANE_OUT_TYPES = [
    C.POINTER(C.c_uint8),
    C.POINTER(C.c_int32), C.POINTER(C.c_int32), C.POINTER(C.c_int32),
    C.POINTER(C.c_int16), C.POINTER(C.c_int16), C.POINTER(C.c_int16),
    C.POINTER(C.c_int8), C.POINTER(C.c_int8), C.POINTER(C.c_int8),
    C.POINTER(C.c_int16), C.POINTER(C.c_int8), C.POINTER(C.c_int8),
    C.POINTER(C.c_int8), C.POINTER(_Info), C.c_int32,
]


def _build() -> str:
    if not os.path.exists(_SRC):
        raise build.BuildError(f"mp3fe source missing: {_SRC}")
    header = gen_luts.huffman_lut_header(build.BUILD_DIR)
    return build.build_shared("mp3fe", "g++", build.GXX_FLAGS, [_SRC], (header,),
                              include_dirs=(os.path.dirname(header),))


def _declare(lib: C.CDLL) -> None:
    lib.mp3fe_probe.restype = None
    lib.mp3fe_probe.argtypes = [C.c_char_p, C.c_int64, C.POINTER(_Info)]
    lib.mp3fe_analyze_batch.restype = None
    lib.mp3fe_analyze_batch.argtypes = [
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64), C.c_int32, C.c_int32,
        C.c_int32,
        C.POINTER(C.c_int16), C.POINTER(C.c_int16), C.POINTER(C.c_int8),
        C.POINTER(C.c_int8), C.POINTER(_Info), C.c_int32,
    ]
    lib.mp3fe_frame_walks.restype = C.c_int64
    lib.mp3fe_frame_walks.argtypes = []
    lib.mp3fe_lanes_batch.restype = None
    lib.mp3fe_lanes_batch.argtypes = [
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64), C.c_int32, C.c_int32,
        C.c_int64, C.c_int32,
    ] + _LANE_OUT_TYPES
    lib.mp3fe_open_batch.restype = C.c_void_p
    lib.mp3fe_open_batch.argtypes = [
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64), C.c_int32, C.c_int32,
        C.POINTER(_Info), C.POINTER(C.c_int32),
    ]
    lib.mp3fe_close.restype = None
    lib.mp3fe_close.argtypes = [C.c_void_p]
    lib.mp3fe_lanes_batch_session.restype = None
    lib.mp3fe_lanes_batch_session.argtypes = [
        C.c_void_p, C.POINTER(C.c_int32), C.c_int32, C.c_int32,
        C.c_int64, C.c_int32,
    ] + _LANE_OUT_TYPES


def _load() -> C.CDLL:
    return build.load_library("mp3fe", _build, _declare)


def available() -> bool:
    try:
        _load()
    except build.BuildError:
        return False
    return True


def frame_walks() -> int:
    """Process-wide count of native frame walks (one per blob per walk)."""
    return int(_load().mp3fe_frame_walks())


def _lane_buffers(B: int, G: int, ch: int, m_cap: int) -> dict:
    return dict(
        main=np.zeros((B, m_cap), np.uint8),
        start=np.zeros((B, G, ch), np.int32),
        end=np.zeros((B, G, ch), np.int32),
        limit=np.zeros((B, G, ch), np.int32),
        big=np.zeros((B, G, ch), np.int16),
        r1=np.zeros((B, G, ch), np.int16),
        r2=np.zeros((B, G, ch), np.int16),
        tsel=np.zeros((B, G, ch, 3), np.int8),
        c1sel=np.zeros((B, G, ch), np.int8),
        valid=np.zeros((B, G, ch), np.int8),
        exp_b=np.zeros((B, G, ch, 61), np.int16),
        cfg=np.zeros((B, G, ch), np.int8),
        stflags=np.zeros((B, G), np.int8),
        sfr=np.zeros((B, G, 61), np.int8),
    )


_CT = {np.uint8: C.c_uint8, np.int8: C.c_int8, np.int16: C.c_int16,
       np.int32: C.c_int32}


def _lane_pointers(r: dict) -> list:
    keys = ("main", "start", "end", "limit", "big", "r1", "r2", "tsel",
            "c1sel", "valid", "exp_b", "cfg", "stflags", "sfr")
    return [r[k].ctypes.data_as(C.POINTER(_CT[r[k].dtype.type])) for k in keys]


def _with_infos(r: dict, infos) -> dict:
    return dict(
        r,
        err=np.asarray([i.err for i in infos], np.int32),
        n_granules=np.asarray([i.n_granules for i in infos], np.int32),
        sample_rate=np.asarray([i.sample_rate for i in infos], np.int32),
        channels=np.asarray([i.channels for i in infos], np.int32),
        main_bytes=np.asarray([i.main_bytes for i in infos], np.int32),
    )


class Mp3Session:
    """One-walk-per-blob front-end session.

    Opening walks every blob exactly once (threaded C++), capturing the
    per-file frame tables; ``infos`` (geometry summaries for grouping),
    ``layers`` (front-end routing) and :meth:`lanes_batch` (lane
    emission) all feed off that single walk.  Blob references are held
    for the session's lifetime: the C++ side stores raw pointers into
    them."""

    def __init__(self, blobs: list[bytes], nthreads: int = 0):
        lib = _load()
        self._lib = lib
        self._blobs = list(blobs)  # keep the buffers alive
        n = len(self._blobs)
        self._buf_ptrs = (C.c_char_p * n)(*self._blobs)
        self._lens = (C.c_int64 * n)(*[len(b) for b in self._blobs])
        infos = (_Info * n)()
        layers = (C.c_int32 * n)()
        self._handle = C.c_void_p(lib.mp3fe_open_batch(
            self._buf_ptrs, self._lens, n, nthreads, infos, layers))
        self.infos = [
            dict(sample_rate=i.sample_rate, channels=i.channels,
                 n_granules=i.n_granules, joint=bool(i.joint), err=i.err,
                 main_bytes=i.main_bytes)
            for i in infos
        ]
        self.layers = [int(x) for x in layers]

    def lanes_batch(self, file_idx: list[int], g_cap: int, m_cap: int,
                    channels: int, nthreads: int = 0) -> dict:
        """Lane emission for selected session files — same output layout
        as module-level :func:`lanes_batch`, but no re-walk."""
        if not self._handle:
            raise ValueError("Mp3Session is closed")
        if m_cap % 4:
            raise ValueError(f"m_cap must be a multiple of 4, got {m_cap}")
        B = len(file_idx)
        r = _lane_buffers(B, g_cap, channels, m_cap)
        infos = (_Info * B)()
        idx = (C.c_int32 * B)(*file_idx)
        self._lib.mp3fe_lanes_batch_session(
            self._handle, idx, B, g_cap, m_cap, channels,
            *_lane_pointers(r), infos, nthreads,
        )
        return _with_infos(r, infos)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.mp3fe_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def probe(blob: bytes) -> dict:
    """Geometry-only frame walk: sr/channels/n_granules/joint/err."""
    lib = _load()
    info = _Info()
    lib.mp3fe_probe(blob, len(blob), C.byref(info))
    return dict(
        sample_rate=info.sample_rate, channels=info.channels,
        n_granules=info.n_granules, joint=bool(info.joint), err=info.err,
        main_bytes=info.main_bytes,
    )


def analyze_batch(
    blobs: list[bytes], g_cap: int, channels: int, joint: bool,
    nthreads: int = 0,
) -> dict:
    """Analyze a uniform (channels, joint) group of MP3 blobs, the Huffman
    decode included, for the host-Huffman route (dsp.mp3_dsp_tail).

    Returns dict of zero-padded host arrays:
      is_q  int16 [B, G, C, 576]   exp_b int16 [B, G, C, 61]
      st    int8  [B, G, 576] or None  (stereo mode bytes; joint stereo only)
      cfg   int8  [B, G, C]  (block_type | mixed<<2)
      err/n_granules/sample_rate/channels int32 [B]
    """
    lib = _load()
    B = len(blobs)
    is_q = np.zeros((B, g_cap, channels, 576), np.int16)
    exp_b = np.zeros((B, g_cap, channels, 61), np.int16)
    st = None
    st_ptr = C.cast(None, C.POINTER(C.c_int8))
    if channels == 2 and joint:
        st = np.zeros((B, g_cap, 576), np.int8)
        st_ptr = st.ctypes.data_as(C.POINTER(C.c_int8))
    cfg = np.zeros((B, g_cap, channels), np.int8)
    infos = (_Info * B)()
    buf_ptrs = (C.c_char_p * B)(*blobs)
    lens = (C.c_int64 * B)(*[len(b) for b in blobs])
    lib.mp3fe_analyze_batch(
        buf_ptrs, lens, B, g_cap, channels,
        is_q.ctypes.data_as(C.POINTER(C.c_int16)),
        exp_b.ctypes.data_as(C.POINTER(C.c_int16)),
        st_ptr,
        cfg.ctypes.data_as(C.POINTER(C.c_int8)),
        infos, nthreads,
    )
    return dict(
        is_q=is_q, exp_b=exp_b, st=st, cfg=cfg,
        err=np.asarray([i.err for i in infos], np.int32),
        n_granules=np.asarray([i.n_granules for i in infos], np.int32),
        sample_rate=np.asarray([i.sample_rate for i in infos], np.int32),
        channels=np.asarray([i.channels for i in infos], np.int32),
    )


def lanes_batch(
    blobs: list[bytes], g_cap: int, m_cap: int, channels: int,
    nthreads: int = 0,
) -> dict:
    """Lane-metadata analysis of a uniform-channel group of MP3 blobs for
    the on-device Huffman path (dsp.mp3_decode_fused).

    Returns dict of zero-padded host arrays:
      main  uint8 [B, Mcap]           start/end/limit int32 [B, G, C]
      big/r1/r2 int16 [B, G, C]       tsel int8 [B, G, C, 3]
      c1sel/valid/cfg int8 [B, G, C]  exp_b int16 [B, G, C, 61]
      stflags int8 [B, G]             sfr int8 [B, G, 61]
      err/n_granules/sample_rate/channels/main_bytes int32 [B]
    """
    lib = _load()
    if m_cap % 4:
        raise ValueError(f"m_cap must be a multiple of 4, got {m_cap}")
    B = len(blobs)
    r = _lane_buffers(B, g_cap, channels, m_cap)
    infos = (_Info * B)()
    buf_ptrs = (C.c_char_p * B)(*blobs)
    lens = (C.c_int64 * B)(*[len(b) for b in blobs])
    lib.mp3fe_lanes_batch(
        buf_ptrs, lens, B, g_cap, m_cap, channels,
        *_lane_pointers(r), infos, nthreads,
    )
    return _with_infos(r, infos)
