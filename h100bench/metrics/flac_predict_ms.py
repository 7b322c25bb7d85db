"""Host milliseconds per call inside the program's ``flac.predict`` ranges
in the traced stretch."""


def read(run):
    tr = run.trace
    if tr is None or not any(n == "flac.predict" for n, _, _ in tr.ranges):
        return None
    return tr.range_s("flac.predict") / tr.calls * 1e3
