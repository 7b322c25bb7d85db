"""Device milliseconds per traced call inside the program's
``flac.rice_scan`` spans (the rice lane scan), from its CUDA event pairs."""

from h100bench import program


def read(run):
    return program.device_ms(run, "flac.rice_scan")
