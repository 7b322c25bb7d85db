"""Host syncs per block the live loop sank: the program's ``sync`` counter
(blocking copies and device-to-host fetches) over its ``engine.block``
counter, both summed over the window's calls."""

from h100bench import engine_spans


def read(run):
    blocks = engine_spans.counted(run, "engine.block", 0)
    return engine_spans.counted(run, "sync", 0) / blocks if blocks else None
