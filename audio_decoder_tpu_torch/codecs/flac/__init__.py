"""FLAC codec family — lossless decode.

Host structural walk (``frontend``, the C++ flacfe walker) + device decode
(``device``): lane-parallel rice scan, exact integer LPC/FIXED predictor
reconstruction, stereo decorrelation and PCM assembly, with the window-add
kernels (ops/window_add.py) on CUDA.
"""

from . import frontend  # noqa: F401
