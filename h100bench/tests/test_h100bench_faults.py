"""Whole runs on the CPU, past the look for a card, with the timed path
broken underneath: each fault a decoder can have must turn ``correct``
false; and each control, the reference in the program's place at the
precision below, must come out not correct from the run's own comparison.
(One card: no exchange between chips to leave out.)"""

import dataclasses

import pytest

from h100bench import control, pool, run
from h100bench.tests.conftest import program_cells, small, small_run

BENCH = run.load_benchmark()


def _stale(decode):
    """A step that hands back its first answer unchanged."""
    first = []

    def f(assets, device):
        if not first:
            first.append(decode(assets, device=device))
        return first[0]
    return f


def _half(decode):
    """Half the work left out: the second half of every file's frames."""
    def f(assets, device):
        b = decode(assets, device=device)
        data = b.data.clone()
        for i, n in enumerate(b.valid_frames.tolist()):
            data[i, (n // 2) * b.channels:n * b.channels] = 0
        return dataclasses.replace(b, data=data)
    return f


def _altered(decode):
    """Each answer altered where it is produced: a click in one sample."""
    def f(assets, device):
        b = decode(assets, device=device)
        data = b.data.clone()
        data[:, 1000] += 0.25
        return dataclasses.replace(b, data=data)
    return f


def _swapped(decode):
    """Two files of each call swap their PCM (a wrong gather)."""
    def f(assets, device):
        b = decode(assets, device=device)
        data = b.data.clone()
        data[[0, 1]] = b.data[[1, 0]]
        return dataclasses.replace(b, data=data)
    return f


def _files_per_call(cell):
    return int({**run.cell_parts(BENCH, cell)[2], **small(cell)[1]}["files_per_call"])


#: each decode cell with each fault it can have (a call of one file has nothing to swap)
CASES = [(cell, fault) for cell in program_cells(BENCH, "decode")
         for fault in (_stale, _half, _altered, _swapped)
         if fault is not _swapped or _files_per_call(cell) > 1]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_a_broken_decode_is_not_correct(cell, fault, cache):
    from audio_decoder_tpu_torch.codecs.registry import decode_assets

    r = small_run(BENCH, cell, cache, seed=2**31 + 99, decode=fault(decode_assets),
                  mix_over={"check_calls": 8})
    if fault is _stale and r["attempted"] == 1:
        pytest.fail("a stale answer needs a second call to show")
    assert r["correct"] is False and r["failed"] >= 1


def test_the_sound_decode_is_correct(cache):
    r = small_run(BENCH, "librispeech-flac.loader", cache, seed=2**31 + 99)
    assert r["correct"] is True and r["failed"] == 0


@pytest.mark.parametrize("cell", ["fma-mp3.loader", "librispeech-flac.loader"])
def test_the_control_in_the_programs_place_is_not_correct(cell, cache):
    _, config, mix = run.cell_parts(BENCH, cell)
    cover, mover = small(cell)
    config, mix = {**config, **cover}, {**mix, **mover}
    inputs, _ = pool.load(config, cache, 1)
    out = control.judged(config, mix, inputs, 2**40 + 7, 1)
    assert out["correct"] is False and out["files"] == 4
    name = "pcm_rel_rms" if cell.startswith("fma") else "bad_samples"
    assert out["checks"][name]["value"] > out["checks"][name]["limit"]
    assert out["checks"]["bad_files"]["value"] == 0
