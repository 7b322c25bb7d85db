"""Codec model families — the decode dispatch surface.

Each supported family is a "model": a host-side probe, an optional
native front-end and a device decode program, bound here as a
``decode_group(assets, *, device)`` callable.  ``codecs.registry`` routes
every asset through this table (extension → model → decode_group).

Families:
  wav — RIFF/WAVE: vectorized chunk parse + fused PCM unpack (8/16/24/32
        bit + IEEE float + A/µ-law), little-endian (codecs/wav.py).
  mp3 — MPEG Layer III: host frame/side-info walk (C++ mp3fe) + on-device
        entropy decode and synthesis (codecs/mpeg/).
  flac — FLAC lossless: host structural walk (C++ flacfe) + on-device rice
        scan, LPC/FIXED reconstruction, stereo decorrelation and window-add
        assembly (codecs/flac/).

The extensions of families the JAX package decodes but this port does not
yet (``NOT_PORTED``) raise ``NotImplementedError`` instead of decoding as
unknown files.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from ..codecs import registry as _registry
from ..codecs.flac import decoder as _flac
from ..codecs.mpeg import decoder as _mpeg


@dataclasses.dataclass(frozen=True)
class CodecModel:
    """One decode family: name, extensions, group decoder.

    ``decode_group(assets, *, device) -> [(family_local_indices,
    AudioBatch), ...]``."""

    name: str
    extensions: tuple
    decode_group: Callable
    bit_exact: bool  # PCM bit-exactness (vs spec-tolerance) guarantee


MODELS = {
    "wav": CodecModel(
        name="wav", extensions=("wav",),
        decode_group=functools.partial(_registry.decode_pcm_family, "wav"),
        bit_exact=True,
    ),
    "mp3": CodecModel(
        name="mp3", extensions=("mp3",),
        decode_group=_mpeg.decode_group,
        bit_exact=False,  # ISO spec tolerance
    ),
    "flac": CodecModel(
        name="flac", extensions=("flac",),
        decode_group=_flac.decode_group,
        bit_exact=True,
    ),
}

#: extension → what is missing (decoded by the JAX package, not yet here)
NOT_PORTED = {
    "aif": "AIFF", "aiff": "AIFF", "aifc": "AIFF-C", "au": "Sun AU",
    "snd": "Sun AU", "caf": "CAF", "mp1": "MPEG Layer I",
    "mp2": "MPEG Layer II",
}


def for_extension(ext: str) -> CodecModel | None:
    """The model decoding ``ext``; None for an unknown extension.  Raises
    ``NotImplementedError`` for an extension not ported yet."""
    ext = ext.lower()
    for m in MODELS.values():
        if ext in m.extensions:
            return m
    if ext in NOT_PORTED:
        raise NotImplementedError(
            f".{ext} ({NOT_PORTED[ext]}) decode is not ported yet "
            "(ROADMAP queue 1)")
    return None


__all__ = ["CodecModel", "MODELS", "NOT_PORTED", "for_extension"]
