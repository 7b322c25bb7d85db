# Verbatim copy of audio_decoder_tpu/io/assets.py (that package imports jax on import).
"""Host-side asset scanning and byte packing.

Mirrors the reference's entry pipeline (blast/src/main.rs:13-89): scan an
assets directory, split extensions, and dispatch by extension — but instead
of decoding one file at a time, files are read and *packed* into
``[B, max_bytes]`` uint8 tensors so the batch crosses host→device once and
all parsing happens on-device.

Max-byte sizes are bucketed to powers of two so jitted parsers compile a
bounded number of shapes regardless of asset-folder contents.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Sequence

import numpy as np

from ..core.errors import InvalidDataError

#: Extensions the dispatcher recognises (≙ main.rs:43-77; "mp3" was a TODO
#: in the reference — completed here).
KNOWN_EXTENSIONS = ("wav", "aif", "aiff", "mp3", "mp2", "mp1")


@dataclasses.dataclass
class Asset:
    """One scanned file: path + stem + extension + raw bytes."""

    path: str
    name: str
    ext: str
    data: bytes


def split_name(path: str) -> tuple[str, str]:
    """Split a path into (stem, extension) with the reference's rules
    (main.rs:38-41, wav.rs:156-164): the extension is everything after the
    last '.', the name is the basename before it; both must be non-empty."""
    base = os.path.basename(path)
    if "." not in base:
        return base, ""
    name, ext = base.rsplit(".", 1)
    if not name or not ext:
        raise InvalidDataError(f"File has no name: {path!r}")
    return name, ext.lower()


def scan_assets(asset_dir: str) -> list[str]:
    """List files in the asset directory (≙ fs::read_dir at main.rs:18),
    sorted for determinism (the reference inherits OS dirent order)."""
    entries = []
    for entry in sorted(os.listdir(asset_dir)):
        full = os.path.join(asset_dir, entry)
        if os.path.isfile(full):
            entries.append(full)
    return entries


def load_assets(paths: Iterable[str]) -> list[Asset]:
    assets = []
    for path in paths:
        name, ext = split_name(path)
        with open(path, "rb") as f:
            data = f.read()
        assets.append(Asset(path=path, name=name, ext=ext, data=data))
    return assets


def bucket_size(n: int, minimum: int = 1024) -> int:
    """Round a byte length up to the next power of two (compile-shape cap)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def pack_bytes(
    blobs: Sequence[bytes], *, bucket: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Pack raw file bytes into a padded u8 [B, N] array + i32 [B] lengths."""
    if not blobs:
        return np.zeros((0, 1024), np.uint8), np.zeros((0,), np.int32)
    longest = max(len(b) for b in blobs)
    width = bucket_size(longest) if bucket else max(longest, 1)
    out = np.zeros((len(blobs), width), np.uint8)
    lens = np.zeros((len(blobs),), np.int32)
    for i, blob in enumerate(blobs):
        arr = np.frombuffer(blob, np.uint8)
        out[i, : len(arr)] = arr
        lens[i] = len(arr)
    return out, lens
