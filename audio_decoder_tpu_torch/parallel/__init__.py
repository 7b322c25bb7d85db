"""Fused single-device decode steps."""
from .decode import decode_pcm_step

__all__ = ["decode_pcm_step"]
