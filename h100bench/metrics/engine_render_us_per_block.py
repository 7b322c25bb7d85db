"""Host microseconds per block issued in the traced stretch inside the live
loop's ``engine.render`` ranges: issuing a block or a burst of blocks."""

from h100bench import engine_spans


def read(run):
    return engine_spans.per_block(run, "engine.render")
