"""audio_decoder_tpu_torch — the PyTorch/CUDA port of audio_decoder_tpu.

Batched decode of mixed WAV and MPEG Layer III folders into one f32
``AudioBatch`` on an explicit device.  On CUDA the MP3 entropy scan and
the synthesis filterbank run as hand-written kernels (``csrc/``, built
with nvcc for sm_90a at first use); on the CPU their plain torch twins
run.  The package imports torch and never jax.

Precision: float32 products must run in full f32 (the JAX package pins
``Precision.HIGHEST``); importing the package therefore sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .core import AudioBatch, AudioFileView, DecodeError  # noqa: E402
from .codecs import decode_assets, decode_dir, decode_paths  # noqa: E402
from .io.assets import scan_assets  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AudioBatch",
    "AudioFileView",
    "DecodeError",
    "decode_assets",
    "decode_dir",
    "decode_paths",
    "scan_assets",
    "__version__",
]
