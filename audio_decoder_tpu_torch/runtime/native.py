"""ctypes binding to the native runtime library (blastrt).

The C++ library is compiled from the port's copy of the source,
``native/runtime.cc``, with g++ into the port's build directory
(utils/build.py).  It provides the three native services the reference
implements through FFI (runtime.rs): the lock-free SPSC command ring
(commands.rs:11-69), the playback sink (runtime.rs:251-394) and raw
terminal control (runtime.rs:431-458).  There is no pure-Python
fallback: if the library cannot be built, every class here raises
``BuildError``.

The sink opens ALSA with ``dlopen`` at run time; without ``libasound``
(or with ``BLAST_ALSA_LIB`` naming a library that is missing) it is a
null sink, which paces itself in real time.  That concerns the audio
device only; rendering still runs on the engine state's device.
"""

from __future__ import annotations

import ctypes as C
import os
import time

import numpy as np

from ..utils import build

_SRC = os.path.join(build.NATIVE_DIR, "runtime.cc")


def _build() -> str:
    if not os.path.exists(_SRC):
        raise build.BuildError(f"runtime source missing: {_SRC}")
    return build.build_shared("blastrt", "g++", build.GXX_FLAGS, [_SRC],
                              libs=("-ldl",))


def _declare(lib: C.CDLL) -> None:
    lib.spsc_create.restype = C.c_void_p
    lib.spsc_create.argtypes = [C.c_int]
    lib.spsc_destroy.argtypes = [C.c_void_p]
    lib.spsc_push.argtypes = [C.c_void_p, C.c_char_p]
    lib.spsc_pop.argtypes = [C.c_void_p, C.c_char_p]
    lib.sink_open.restype = C.c_void_p
    lib.sink_open.argtypes = [C.c_char_p, C.c_int, C.c_int]
    lib.sink_open_mode.restype = C.c_void_p
    lib.sink_open_mode.argtypes = [C.c_char_p, C.c_int, C.c_int, C.c_int]
    lib.sink_is_null.argtypes = [C.c_void_p]
    lib.sink_mode.argtypes = [C.c_void_p]
    lib.sink_write.restype = C.c_int
    lib.sink_write.argtypes = [C.c_void_p, C.POINTER(C.c_int16), C.c_int]
    lib.sink_close.argtypes = [C.c_void_p]


def load_library() -> C.CDLL:
    """Build (once per process) and load blastrt; raises ``BuildError``."""
    return build.load_library("blastrt", _build, _declare)


def available() -> bool:
    """Whether blastrt builds and loads here."""
    try:
        load_library()
    except build.BuildError:
        return False
    return True


class CmdRing:
    """Lock-free native SPSC ring of command lines (capacity - 1 usable
    slots, like the reference's CmdQueue)."""

    def __init__(self, capacity: int = 256):
        self._lib = load_library()
        self._h = self._lib.spsc_create(capacity)
        self._buf = C.create_string_buffer(256)

    def try_push(self, cmd: str) -> bool:
        return self._lib.spsc_push(self._h, cmd.encode()) == 0

    def try_pop(self) -> str | None:
        if self._lib.spsc_pop(self._h, self._buf) != 0:
            return None
        return self._buf.value.decode(errors="replace")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.spsc_destroy(self._h)
            self._h = None


class Sink:
    """Playback sink: the ALSA device when one opens, else a null sink paced
    in real time; ``realtime=False`` opens no device and does not pace
    (offline rendering, tests).  ``capture`` keeps every int16 block
    written."""

    def __init__(self, device: str, rate: int, channels: int,
                 capture: bool = False, realtime: bool = True,
                 mode: str = "auto"):
        """mode: "auto" (mmap with writei fallback, like the reference's
        MMAP_INTERLEAVED device, runtime.rs:267-295), "writei", or
        "mmap" (required — null sink if unsupported)."""
        self.rate = rate
        self.channels = channels
        self.capture = [] if capture else None
        self._h = None
        self._realtime = realtime
        self._lib = load_library()
        if realtime:
            m = {"auto": 0, "writei": 1, "mmap": 2}[mode]
            self._h = self._lib.sink_open_mode(device.encode(), rate, channels, m)

    @property
    def is_hardware(self) -> bool:
        return self._h is not None and self._lib.sink_is_null(self._h) == 0

    @property
    def mode(self) -> str:
        """"null", "writei" or "mmap" — which device path is active."""
        if self._h is None:
            return "null"
        return {0: "null", 1: "writei", 2: "mmap"}[int(self._lib.sink_mode(self._h))]

    def write(self, block: np.ndarray) -> None:
        """block: f32 [frames, channels] in [-1, 1]."""
        pcm = np.clip(np.round(block * 32767.0), -32768, 32767).astype("<i2")
        if self.capture is not None:
            self.capture.append(pcm.copy())
        if self._h is not None:
            flat = np.ascontiguousarray(pcm)
            self._lib.sink_write(
                self._h, flat.ctypes.data_as(C.POINTER(C.c_int16)), pcm.shape[0]
            )
        elif self._realtime:
            time.sleep(pcm.shape[0] / self.rate)

    def close(self) -> None:
        if self._h is not None:
            self._lib.sink_close(self._h)
            self._h = None


class RawTerminal:
    """Raw-mode guard with signal/exception-safe restore
    (≙ raw_mode + panic hook, runtime.rs:419-452)."""

    def __enter__(self):
        self._lib = load_library()
        self._on = self._lib.term_raw_on() == 0
        return self

    def read_char(self) -> int:
        return self._lib.term_read_char()

    def __exit__(self, *exc):
        if self._on:
            self._lib.term_raw_off()
        return False
