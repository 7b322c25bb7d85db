"""MPEG audio decode (Layer III) on torch tensors."""
