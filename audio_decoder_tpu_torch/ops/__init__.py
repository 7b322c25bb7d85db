"""Batched byte readers, PCM unpack and the synthesis kernel wrapper."""
