"""Host milliseconds per call inside the program's ``flac.rice_scan``
ranges in the traced stretch."""


def read(run):
    tr = run.trace
    if tr is None or not any(n == "flac.rice_scan" for n, _, _ in tr.ranges):
        return None
    return tr.range_s("flac.rice_scan") / tr.calls * 1e3
