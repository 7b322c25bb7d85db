"""Device milliseconds per traced call inside the program's
``mp3.imdct`` spans (antialias, the fixed-row IMDCT products,
overlap-add), from its CUDA event pairs."""

from h100bench import program


def read(run):
    return program.device_ms(run, "mp3.imdct")
