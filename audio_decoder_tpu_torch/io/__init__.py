"""Host-side asset scanning and byte packing, and streaming decode."""

from .assets import (
    KNOWN_EXTENSIONS,
    Asset,
    bucket_size,
    load_assets,
    pack_bytes,
    scan_assets,
    split_name,
)
from .stream import decode_all, stream_decode, stream_file

__all__ = [
    "KNOWN_EXTENSIONS",
    "Asset",
    "bucket_size",
    "load_assets",
    "pack_bytes",
    "scan_assets",
    "split_name",
    "decode_all",
    "stream_decode",
    "stream_file",
]
