"""Device microseconds per block issued in the traced stretch: the union of
the device events each ``engine.render.<depth>`` range launched (from the
profiler's trace, ``engine_spans.render_device_us``), over the blocks those
ranges issued.  The fetches' device-to-host copies are left out."""

from h100bench import engine_spans


def read(run):
    blocks = engine_spans.rendered(run.trace)
    got = engine_spans.render_device_us(run.trace)
    if blocks is None or got is None or not run.trace.device:
        return None
    return got[0] / blocks
