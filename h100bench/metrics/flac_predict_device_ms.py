"""Device milliseconds per traced call inside the program's
``flac.predict`` spans (the predictor reconstruction), from its CUDA event
pairs."""

from h100bench import program


def read(run):
    return program.device_ms(run, "flac.predict")
