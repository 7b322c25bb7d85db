"""Tracing and native build helpers."""
