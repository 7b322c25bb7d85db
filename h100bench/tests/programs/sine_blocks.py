"""A toy program for the tests of the loop: a seeded sine per channel,
rendered by torch in blocks of ``block_frames``, ``blocks_per_call`` a
call, at the pool's sample rate and channel count, judged against NumPy in
float64.  Its mix keys: ``block_frames``, ``blocks_per_call``.  It hands
over no files.  On a cell of several cards the blocks of a call are dealt
to the cards in turn and joined on the first; its record names the card
of each block.

``start``'s hook ``alter`` changes each call's output where it is made
(the tests plant a fault with it).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Block:
    k: int
    audio_s: float
    files: list
    cards: list


def pieces(config: dict, mix: dict) -> list[str]:
    if int(mix["block_frames"]) < 1 or int(mix["blocks_per_call"]) < 1:
        raise ValueError("a call renders at least one frame")
    return []


def start(config, mix, inputs, seed, device, alter=None, cards=None):
    return Session(mix, inputs, seed, cards or [device], alter)


class Session:
    def __init__(self, mix, inputs, seed, cards, alter):
        import torch

        self.torch, self.cards, self.alter = torch, cards, alter
        self.rate, self.channels = inputs.sample_rate, inputs.channels
        self.block, self.blocks = int(mix["block_frames"]), int(mix["blocks_per_call"])
        self.hz = np.random.default_rng([seed, 9]).uniform(50.0, 2000.0, self.channels)

    def frames(self, k: int) -> int:
        return k * self.block * self.blocks

    def call(self, k: int):
        torch = self.torch
        hz = {c: torch.tensor(self.hz, dtype=torch.float64, device=c) for c in set(self.cards)}
        out, used = [], []
        for b in range(self.blocks):
            card = self.cards[b % len(self.cards)]
            n = torch.arange(self.block, dtype=torch.float64, device=card)
            t = (self.frames(k) + b * self.block + n)[:, None] / self.rate
            out.append(torch.sin(2 * np.pi * hz[card] * t).to(torch.float32).to(self.cards[0]))
            used.append(card)
        pcm = torch.cat(out)
        if self.alter is not None:
            pcm = self.alter(pcm)
        finite = bool(torch.isfinite(pcm).all().cpu())   # waits for every card's block
        return Block(k, self.block * self.blocks / self.rate if finite else 0.0, [], used), pcm

    def to_host(self, record: Block, pcm):
        return pcm.cpu().numpy()

    def close(self) -> None:
        pass

    def judge(self, records: list[Block], kept: dict, workers: int):
        worst = 0.0
        for p, got in kept.items():
            n = self.frames(records[p].k) + np.arange(self.block * self.blocks)
            want = np.sin(2 * np.pi * self.hz * (n[:, None] / self.rate))
            worst = max(worst, float(np.abs(got - want).max()))
        failed = sum(1 for r in records if r.audio_s == 0)
        return {"max_abs": (worst, 1e-6)}, failed
