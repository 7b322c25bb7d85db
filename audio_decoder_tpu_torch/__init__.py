"""audio_decoder_tpu_torch — the PyTorch/CUDA port of audio_decoder_tpu.

Batched decode of mixed WAV, AIFF/AIFF-C, AU, CAF, MPEG Layer I/II/III
and FLAC folders into one f32 ``AudioBatch`` on an explicit device
(``decode_dir``, ``decode_paths``, ``decode_assets``); streaming decode
of many files (``stream_decode``, ``io.decode_all``) and of one long
file in fixed chunks with bounded device memory (``stream_file``); and
the batch DSP: consensus rate and channels (``consensus_for``),
polyphase resampling (``resample_batch``, ``resample_to_consensus``) and
channel routing (``route_channels``).  Every entry point takes
``device=`` (default ``"cuda"``, which raises without a card).  On
CUDA the MP3 entropy scan, the MPEG synthesis filterbank and the FLAC
window-add assembly run as hand-written kernels (``csrc/``, built with
nvcc for sm_90a at first use); on the CPU their plain torch twins run.
The package imports torch and never jax.

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
from .dsp import (  # noqa: E402
    consensus_for,
    resample_batch,
    resample_to_consensus,
    route_channels,
)
from .io.assets import scan_assets  # noqa: E402
from .io.stream import stream_decode, stream_file  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AudioBatch",
    "AudioFileView",
    "DecodeError",
    "decode_assets",
    "decode_dir",
    "decode_paths",
    "scan_assets",
    "stream_decode",
    "stream_file",
    "consensus_for",
    "resample_batch",
    "resample_to_consensus",
    "route_channels",
    "__version__",
]
