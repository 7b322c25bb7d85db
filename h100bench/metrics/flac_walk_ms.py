"""Host milliseconds per traced call inside the program's ``flac.walk``
spans: flacfe's threaded structural walk of every blob of a call."""

from h100bench import program


def read(run):
    return program.host_ms(run, "flac.walk")
