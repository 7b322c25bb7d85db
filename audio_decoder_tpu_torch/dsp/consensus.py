"""Consensus output configuration as tensor reductions.

The reference scans its loaded tracks and picks the most frequent sample
rate (blast/src/main.rs:91-105) and the maximum channel count
(main.rs:107-120), with 44100 Hz / 2 ch fallbacks.  Here both are O(B²)/O(B)
reductions over the batch metadata on its device, with errored files
masked out.

Tie-break: the reference iterates a HashMap (unspecified order); we pick the
first-seen rate among the most frequent (``torch.argmax`` returns the first
index among equal maxima), which is deterministic.

It is the port of the JAX package's ``dsp/consensus.py``.
"""

from __future__ import annotations

import torch

from ..core.batch import AudioBatch


def consensus_config(
    sample_rate: torch.Tensor,   # i32 [B]
    num_channels: torch.Tensor,  # i32 [B]
    err: torch.Tensor,           # i32 [B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (consensus_rate, consensus_channels) as i32 scalars on the
    inputs' device."""
    dev = sample_rate.device
    if sample_rate.shape[0] == 0:  # empty batch → reference fallbacks
        return (torch.tensor(44100, dtype=torch.int32, device=dev),
                torch.tensor(2, dtype=torch.int32, device=dev))
    valid = err == 0
    pair_valid = valid[:, None] & valid[None, :]
    same = sample_rate[:, None] == sample_rate[None, :]
    counts = (same & pair_valid).sum(dim=1)
    counts = torch.where(valid, counts, -1)
    any_valid = valid.any()
    winner = torch.argmax(counts)  # first occurrence among maxima
    rate = torch.where(any_valid, sample_rate[winner], 44100).to(torch.int32)
    ch = torch.where(valid, num_channels, 0).max()
    ch = torch.where(any_valid, ch, 2).to(torch.int32)
    return rate, ch


def consensus_for(batch: AudioBatch, *, device="cuda") -> tuple[int, int]:
    """Host convenience: consensus (rate, channels) for a decoded batch,
    reduced on ``device`` (the one host sync)."""
    from ..codecs.registry import resolve_device

    dev = resolve_device(device)
    r, c = consensus_config(batch.sample_rate.to(dev),
                            batch.num_channels.to(dev), batch.err.to(dev))
    return int(r), int(c)
