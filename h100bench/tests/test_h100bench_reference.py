"""The references, their controls and the roofline counts."""

import ast
import os

import numpy as np
import pytest

from h100bench import control, roofline
from h100bench.inputs import music_mp3
from h100bench.reference import mp3
from h100bench.tests.conftest import ROOT

#: a LAME stream (10 s, 128 kbps joint stereo, short blocks, scalefactors
#: and the bit reservoir): what the reference must read besides the
#: benchmark's own writer
STREAM = open(os.path.join(ROOT, "h100bench", "inputs", "data", "stereo_44k1_128k_js.mp3"),
              "rb").read()


def _written():
    cfg = {"sample_rate": 44100, "clip_seconds": 2.0, "pool_seed": 5,
           "bitrates_kbps": [320]}
    return music_mp3.make_files(cfg, [0])[0][0]


@pytest.mark.parametrize("which", ["lame", "writer"])
def test_the_mp3_reference_agrees_with_the_programs_cpu_path(which):
    from audio_decoder_tpu_torch.codecs.registry import decode_assets
    from audio_decoder_tpu_torch.io.assets import Asset

    blob = STREAM if which == "lame" else _written()
    want, sr = mp3.decode(blob)
    assert sr == 44100 and want.shape == (len(mp3.find_frames(blob)) * 1152, 2)
    got = decode_assets([Asset(path="a.mp3", name="a", ext="mp3", data=blob)], device="cpu")
    pcm = got.data[0, :want.size].numpy().reshape(-1, 2).astype(np.float64)
    assert int(got.valid_frames[0]) == len(want) and int(got.err[0]) == 0
    assert np.sqrt(np.mean((pcm - want) ** 2) / np.mean(want ** 2)) < 1e-6


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -3.14159, 1e-3])
    y = control.bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2 ** -6
    assert np.all(np.abs(y - x) <= np.abs(x) * 2 ** -8)


def test_the_roofline_counts_match_hand_counts():
    lanes, coded = mp3.huffman_bits(STREAM)
    assert lanes == 384 * 2 * 2 and coded == 3511224 // 3
    assert roofline.k1_seconds(STREAM) == pytest.approx((coded / 8 + lanes * 1152) / 3.35e12)
    samples = 384 * 1152 * 2
    assert roofline.k2_seconds(STREAM) == pytest.approx(
        max(8 * samples / 3.35e12, samples / 32 * (2 * 64 * 32 + 2 * 32 * 16) / 67e12))
    assert roofline.k3_seconds(1000) == roofline.k4_seconds(1000) == pytest.approx(8000 / 3.35e12)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    base = os.path.join(ROOT, "h100bench")
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.relpath(os.path.join(d, n), base), os.path.join(d, n)


def test_nothing_imports_jax_and_the_yardstick_nothing_of_the_program():
    seen = 0
    for rel, path in _sources():
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "audio_decoder_tpu"}, rel
        if rel.split(os.sep)[0] in ("reference", "inputs", "metrics") or rel in (
                "roofline.py", "traffic.py", "check.py", "trace.py"):
            assert "audio_decoder_tpu_torch" not in tops, rel
        seen += 1
    assert seen > 20
