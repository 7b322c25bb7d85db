"""Host milliseconds per traced call inside the program's ``mp3.walk``
spans: mp3fe's threaded frame walk of every blob of a call."""

from h100bench import program


def read(run):
    return program.host_ms(run, "mp3.walk")
