"""Build native libraries from the repo's sources at first use.

Two kinds of shared library are built here, both with a plain C
interface loaded through ``ctypes``:

* the CUDA kernels under ``audio_decoder_tpu_torch/csrc/``, with ``nvcc``
  for ``sm_90a`` (Hopper);
* the host front-ends under ``audio_decoder_tpu_torch/native/`` (the MP3
  ``mp3fe`` and the FLAC ``flacfe``), with ``g++``.  mp3fe's Huffman
  tables header is generated into the build directory first
  (utils/gen_luts.py).

Outputs go to ``audio_decoder_tpu_torch/build/`` (listed in .gitignore),
named by a hash of the sources and the command, so a stale library is
never loaded and concurrent build processes (test workers) never clobber each
other: each writes a private temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]

#: seconds spent compiling each library in this process (0.0 when the
#: library was already built), keyed by library name
BUILD_SECONDS: dict[str, float] = {}

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


def _digest(paths: list[str], cmd: list[str]) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_shared(name: str, compiler: str, flags: list[str],
                 sources: list[str], deps: tuple[str, ...] = (),
                 include_dirs: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` into ``build/lib<name>-<hash>.so``; return its path.

    The hash covers the command and the contents of ``sources`` and
    ``deps`` (headers found through ``include_dirs``)."""
    cmd = [compiler] + flags
    out = os.path.join(BUILD_DIR, f"lib{name}-{_digest(sources + list(deps), cmd)}.so")
    cmd = cmd + [f"-I{d}" for d in include_dirs]
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd + ["-o", tmp] + sources, capture_output=True,
                              text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"building {name}: {e}") from e
    if proc.returncode != 0:
        raise BuildError(f"building {name} failed ({' '.join(cmd)}):\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise BuildError("nvcc not found (CUDA toolkit needed to build the kernels)")


def load_library(name: str, build, declare) -> ctypes.CDLL:
    """Build (once per process) and load a library.

    ``build()`` returns the library's path; ``declare(lib)`` sets the
    ``argtypes``/``restype`` of its functions before anyone calls them.
    Each library has its own lock, so threads build different libraries
    at the same time."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise BuildError(f"loading {path}: {e}") from e
            declare(lib)
            _libs[name] = lib
        return lib


def load_cuda_kernels(name: str, declare) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` with nvcc for sm_90a and load it."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return load_library(
        name, lambda: build_shared(name, nvcc_path(), NVCC_FLAGS, [src]),
        declare)
