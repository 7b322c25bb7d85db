"""Device milliseconds per traced call inside the program's
``mp3.stereo`` spans (derive_stereo_coeffs and the 2x2 mixing), from its
CUDA event pairs."""

from h100bench import program


def read(run):
    return program.device_ms(run, "mp3.stereo")
