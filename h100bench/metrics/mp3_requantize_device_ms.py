"""Device milliseconds per traced call inside the program's
``mp3.requantize`` spans (the band gains expanded to lines by the one-hot
products, then sign(is)·|is|^(4/3)·gain), from its CUDA event pairs."""

from h100bench import program


def read(run):
    return program.device_ms(run, "mp3.requantize")
