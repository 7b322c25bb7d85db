"""Device events (kernels, copies, memsets) per decode call in the traced
stretch."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return len(tr.device) / tr.calls
