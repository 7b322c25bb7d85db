"""Host microseconds per block issued in the traced stretch inside the live
loop's ``engine.fetch`` ranges: a burst's copy to the host, which waits for
its device work."""

from h100bench import engine_spans


def read(run):
    return engine_spans.per_block(run, "engine.fetch")
