"""Share of the blocks the live loop rendered that it threw away: speculated
blocks a command made stale (``engine.discard`` items over ``engine.burst``
items, summed over the window's calls), in %."""

from h100bench import engine_spans


def read(run):
    rendered = engine_spans.counted(run, "engine.burst", 1)
    return 100.0 * engine_spans.counted(run, "engine.discard", 1) / rendered if rendered else None
