"""Codec model families — the decode dispatch surface.

Each supported family is a "model": a host-side probe, an optional
native front-end and a device decode program, bound here as a
``decode_group(assets, *, device)`` callable.  ``codecs.registry`` routes
every asset through this table (extension → model → decode_group).

Families:
  wav  — RIFF/WAVE: vectorized chunk parse + fused PCM unpack (8/16/24/32
         bit + IEEE float + A/µ-law), little-endian, and the IMA and MS
         ADPCM unpackers (codecs/wav.py, ops/unpack.py).
  aiff — FORM/AIFF: big-endian PCM + IEEE-80 rates, the AIFF-C codes
         sowt, fl32/fl64, ulaw/alaw and ima4 (codecs/aiff.py).
  au   — Sun AU / NeXT SND: fixed big-endian header, G.711 + PCM + float
         encodings (codecs/au.py).
  caf  — Apple CAF: lpcm, ulaw/alaw and ima4 (codecs/caf.py).
  mp3  — MPEG-1/2/2.5 Layers I/II/III, routed by layer: the host
         frame walk (C++ mp3fe) + on-device entropy decode and synthesis
         for Layer III; the host fixed-width walk + on-device
         requantisation and synthesis for Layers I/II (codecs/mpeg/).
  flac — FLAC lossless: host structural walk (C++ flacfe) + on-device rice
         scan, LPC/FIXED reconstruction, stereo decorrelation and
         window-add assembly (codecs/flac/).
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
    "aiff": CodecModel(
        name="aiff", extensions=("aif", "aiff", "aifc"),
        decode_group=functools.partial(_registry.decode_pcm_family, "aiff"),
        bit_exact=True,
    ),
    "au": CodecModel(
        name="au", extensions=("au", "snd"),
        decode_group=functools.partial(_registry.decode_pcm_family, "au"),
        bit_exact=True,
    ),
    "caf": CodecModel(
        name="caf", extensions=("caf",),
        decode_group=functools.partial(_registry.decode_pcm_family, "caf"),
        bit_exact=True,
    ),
    "mp3": CodecModel(
        name="mp3", extensions=("mp3", "mp2", "mp1"),
        decode_group=_mpeg.decode_group,
        bit_exact=False,  # ISO spec tolerance
    ),
    "flac": CodecModel(
        name="flac", extensions=("flac",),
        decode_group=_flac.decode_group,
        bit_exact=True,
    ),
}

def for_extension(ext: str) -> CodecModel | None:
    """The model decoding ``ext``; None for an unknown extension."""
    ext = ext.lower()
    for m in MODELS.values():
        if ext in m.extensions:
            return m
    return None


__all__ = ["CodecModel", "MODELS", "for_extension"]
