"""Device events (kernels, copies, memsets) in the traced stretch per block
the live loop issued in it (``engine.render.<depth>`` ranges)."""

from h100bench import engine_spans


def read(run):
    blocks = engine_spans.rendered(run.trace)
    if blocks is None or not run.trace.device:
        return None
    return len(run.trace.device) / blocks
