"""Megabytes copied from the host to the device per decode call: the
program's ``h2d`` counter (bytes) over its calls of decode_assets in this
process."""

from h100bench import program


def read(run):
    value = program.per_call("h2d", "items")
    return None if value is None else value / 1e6
