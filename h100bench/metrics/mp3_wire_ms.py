"""Host milliseconds per traced call inside the program's ``mp3.wire``
spans: lane emission, bucket plan, wire compaction and every
host-to-device copy of the wire, its permutation and its metadata."""

from h100bench import program


def read(run):
    return program.host_ms(run, "mp3.wire")
