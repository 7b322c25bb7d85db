"""Batched audio containers on torch tensors.

``AudioBatch`` holds the same flat interleaved float32 PCM as the JAX
package's container, ``data [B, S*C]``, plus per-file metadata tensors.
It is a frozen dataclass of tensors: every tensor of one batch lives on
one device, and ``file(i)`` copies a single trimmed row to the host as
numpy.  16-bit sources stay bit-exact under the ``i16 / 32768`` mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AudioBatch:
    """A batch of decoded audio files.

    Attributes:
      data: f32 ``[B, S*C]`` zero-padded flat interleaved PCM in [-1, 1).
      sample_rate: i32 ``[B]`` per-file sample rate in Hz.
      num_channels: i32 ``[B]`` valid channels per file (<= C).
      bits_per_sample: i32 ``[B]`` source bit depth.
      valid_frames: i32 ``[B]`` unpadded frame count per file.
      err: i32 ``[B]`` per-file decode error code (see core.errors).
      names: tuple of file stems.
      formats: tuple of source formats ("wav"/"mp3"/...).
      channels: storage channel count C of the interleaving.
    """

    data: torch.Tensor
    sample_rate: torch.Tensor
    num_channels: torch.Tensor
    bits_per_sample: torch.Tensor
    valid_frames: torch.Tensor
    err: torch.Tensor
    names: tuple = ()
    formats: tuple = ()
    channels: int = 1

    @classmethod
    def from_pcm(cls, pcm: torch.Tensor, **kw) -> "AudioBatch":
        """Build from a planar ``[B, S, C]`` PCM tensor (flattening is free
        in C order)."""
        B, _S, C = pcm.shape
        return cls(data=pcm.reshape(B, -1), channels=int(C), **kw)

    @property
    def pcm(self) -> torch.Tensor:
        """Planar ``[B, S, C]`` view of ``data``."""
        B, SC = self.data.shape
        return self.data.reshape(B, SC // self.channels, self.channels)

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def max_frames(self) -> int:
        return self.data.shape[1] // self.channels

    @property
    def max_channels(self) -> int:
        return self.channels

    def audio_seconds(self) -> torch.Tensor:
        """Total decoded (unpadded) audio duration in seconds."""
        ok = self.err == 0
        dur = self.valid_frames / torch.clamp(self.sample_rate, min=1)
        return torch.where(ok, dur, torch.zeros_like(dur)).sum()

    def file(self, i: int) -> "AudioFileView":
        """Host-side single-file view (trims padding)."""
        frames = int(self.valid_frames[i])
        ch = int(self.num_channels[i])
        C = self.channels
        row = self.data[i, : frames * C].cpu().numpy().reshape(frames, C)
        return AudioFileView(
            file_name=self.names[i] if i < len(self.names) else str(i),
            format=self.formats[i] if i < len(self.formats) else "",
            sample_rate=int(self.sample_rate[i]),
            num_channels=ch,
            bits_per_sample=int(self.bits_per_sample[i]),
            pcm=row[:, :ch],
            err=int(self.err[i]),
        )


@dataclasses.dataclass
class AudioFileView:
    """Host-side view of one decoded file with f32 planar PCM."""

    file_name: str
    format: str
    sample_rate: int
    num_channels: int
    bits_per_sample: int
    pcm: np.ndarray  # f32 [frames, channels]
    err: int = 0

    @property
    def interleaved_i16(self) -> np.ndarray:
        """Interleaved i16 PCM."""
        x = np.clip(np.round(self.pcm * 32768.0), -32768, 32767)
        return x.astype(np.int16).reshape(-1)


def expand_flat(data: torch.Tensor, channels: int, smax: int,
                cmax: int) -> torch.Tensor:
    """Re-interleave flat ``[B, S*C]`` PCM into flat ``[B, smax*cmax]``,
    zero-filling both the added channels and the added frames."""
    B, SC = data.shape
    S = SC // channels
    pos = torch.arange(smax * cmax, dtype=torch.int64, device=data.device)
    frame, ch = pos // cmax, pos % cmax
    ok = (ch < channels) & (frame < S)
    src = torch.where(ok, frame * channels + ch, torch.zeros_like(pos))
    return torch.where(ok[None, :], data[:, src], torch.zeros((), dtype=data.dtype,
                                                              device=data.device))


def host_audio_seconds(valid_frames, sample_rate) -> float:
    """Decoded audio-seconds of host metadata arrays: the sum of
    ``valid_frames / sample_rate``, a rate of 0 read as 1."""
    rate = np.maximum(np.asarray(sample_rate), 1)
    return float((np.asarray(valid_frames) / rate).sum())


def concat_batches(batches: Sequence[AudioBatch]) -> AudioBatch:
    """Concatenate decode-group results back into one batch (host order)."""
    smax = max(b.max_frames for b in batches)
    cmax = max(b.max_channels for b in batches)
    rows = []
    for b in batches:
        if b.channels == cmax:
            # frames-only mismatch: the extension is a contiguous zero suffix
            pad = smax * cmax - b.data.shape[1]
            rows.append(torch.nn.functional.pad(b.data, (0, pad)) if pad
                        else b.data)
        else:
            rows.append(expand_flat(b.data, b.channels, smax, cmax))
    return AudioBatch(
        data=torch.cat(rows, dim=0),
        channels=cmax,
        sample_rate=torch.cat([b.sample_rate for b in batches]),
        num_channels=torch.cat([b.num_channels for b in batches]),
        bits_per_sample=torch.cat([b.bits_per_sample for b in batches]),
        valid_frames=torch.cat([b.valid_frames for b in batches]),
        err=torch.cat([b.err for b in batches]),
        names=sum((tuple(b.names) for b in batches), ()),
        formats=sum((tuple(b.formats) for b in batches), ()),
    )
