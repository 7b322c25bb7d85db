"""Host microseconds per ``engine.apply`` range in the traced stretch: the
live loop's ring drain and ``commands.apply``; each call of the live mix
submits one command, which the loop drains in one range."""


def read(run):
    tr = run.trace
    spans = [b - a for n, a, b in (tr.ranges if tr else []) if n == "engine.apply"]
    return sum(spans) / len(spans) if spans else None
