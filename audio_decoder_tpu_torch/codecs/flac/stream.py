"""Chunked single-file FLAC decode: bounded memory, one sizing.

FLAC frames are independent, so chunking is exact with no warm-up: the
host walk runs once over the whole file, then windows of frames decode
through the same device program the batch path uses, each from just the
byte slice those frames occupy.  Static dims are the max over all chunks,
and device memory is O(frames_per_chunk).

It is the port of the JAX package's ``codecs/flac/stream.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ...core import errors as E
from ...utils.trace import to_host
from . import frontend
from .decoder import _decode_batch, sizing_for


def slice_frames(an: frontend.FlacAnalysis, f0: int, f1: int
                 ) -> frontend.FlacAnalysis:
    """A standalone analysis of frames ``[f0, f1)``: byte payload sliced
    to their span, bit positions / sublane indices / sample starts
    rebased.  Lane arrays are emitted in walk (frame) order, so every
    per-frame selection is a contiguous range."""
    ch = an.channels
    b0, b1 = int(an.byte_offs[f0]), int(an.byte_offs[f1])
    sub0, sub1 = f0 * ch, f1 * ch
    bit0 = b0 * 8
    rm = (an.rl_sub >= sub0) & (an.rl_sub < sub1)
    wm = (an.fw_sub >= sub0) & (an.fw_sub < sub1)
    dm = (an.dv_sub >= sub0) & (an.dv_sub < sub1)
    s0 = int(an.starts[f0])
    total = max(0, min(an.total, int(an.starts[f1 - 1])
                       + int(an.blocksizes[f1 - 1])) - s0)
    return dataclasses.replace(
        an,
        total=total,
        data=an.data[b0:b1],
        blocksizes=an.blocksizes[f0:f1],
        starts=an.starts[f0:f1] - s0,
        ch_mode=an.ch_mode[f0:f1],
        byte_offs=an.byte_offs[f0: f1 + 1] - b0,
        sub_frame=an.sub_frame[sub0:sub1] - f0,
        sub_ch=an.sub_ch[sub0:sub1],
        sub_kind=an.sub_kind[sub0:sub1],
        sub_order=an.sub_order[sub0:sub1],
        sub_shift=an.sub_shift[sub0:sub1],
        sub_wasted=an.sub_wasted[sub0:sub1],
        sub_coeffs=an.sub_coeffs[sub0:sub1],
        rl_sub=an.rl_sub[rm] - sub0, rl_bitpos=an.rl_bitpos[rm] - bit0,
        rl_count=an.rl_count[rm], rl_param=an.rl_param[rm],
        rl_dest=an.rl_dest[rm],
        fw_sub=an.fw_sub[wm] - sub0, fw_bitpos=an.fw_bitpos[wm] - bit0,
        fw_count=an.fw_count[wm], fw_width=an.fw_width[wm],
        fw_dest=an.fw_dest[wm],
        dv_sub=an.dv_sub[dm] - sub0, dv_dest=an.dv_dest[dm],
        dv_val=an.dv_val[dm],
    )


class FlacStream:
    """Chunked decode of one FLAC file on ``device`` (bounded memory,
    exact output).

    Yields float32 ``[samples, channels]`` host chunks; concatenated
    output equals the one-shot batch decode bit for bit."""

    def __init__(self, data: bytes, frames_per_chunk: int = 64, *,
                 device="cuda"):
        if frames_per_chunk < 1:
            raise ValueError("frames_per_chunk must be >= 1")
        self.device = device
        self.an = frontend.analyze(data)
        self.fpc = int(frames_per_chunk)
        self.channels = self.an.channels
        self.sample_rate = self.an.sample_rate
        self.total_samples = self.an.total
        F = self.an.n_frames
        # one sizing = max over every chunk
        self._slices = [
            slice_frames(self.an, a, min(a + self.fpc, F))
            for a in range(0, F, self.fpc)
        ]
        self._starts = [int(self.an.starts[a])
                        for a in range(0, F, self.fpc)]
        self._sizing = (sizing_for(self._slices, combine="max")
                        if self._slices else None)

    def chunks(self, start_sample: int = 0) -> Iterator[np.ndarray]:
        """Yield PCM from ``start_sample`` onward (sample-exact seek)."""
        if start_sample >= self.total_samples:
            return
        for k, sl in enumerate(self._slices):
            lo = self._starts[k]
            if lo + sl.total <= start_sample:
                continue
            batch = _decode_batch([sl], [f"chunk{k}"], self.device,
                                  sizing=self._sizing)
            E.raise_for_code(int(to_host(batch.err[:1])[0]), "flac stream")
            pcm = to_host(batch.data[0]).reshape(-1, batch.channels)[: sl.total]
            skip = max(0, start_sample - lo)
            yield pcm[skip:]
