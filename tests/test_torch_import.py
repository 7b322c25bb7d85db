"""PyTorch port: imports without JAX, and carries the JAX package's
constant tables exactly."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from audio_decoder_tpu.codecs.mpeg import dsp as JD
from audio_decoder_tpu.codecs.mpeg import huffman_device as JHD
from audio_decoder_tpu.codecs.mpeg import tables as JT
from audio_decoder_tpu_torch.codecs.mpeg import dsp as PD

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "audio_decoder_tpu_torch"


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in neither jax nor the JAX
    package (the GPU machine has no JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_decoder_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'audio_decoder_tpu' or k.startswith('audio_decoder_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import audio_decoder_tpu\b"
                     r"|from audio_decoder_tpu\b(?!_torch))", re.M)
    hits = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
            if pat.search(p.read_text())]
    assert hits == []


def _jax_constants() -> dict:
    return {
        "SYNTH_N": np.asarray(JT.SYNTH_N),
        "_G2": JD._G2, "_W_ALL": JD._W_ALL, "_FREQINV": JD._FREQINV,
        "_ST_LUT": JD._ST_LUT, "_L2B_VARIANTS": JD._L2B_VARIANTS,
        "_USED_SLOTS": JD._USED_SLOTS, "_LINE2BAND": JD._LINE2BAND,
        "_SEG_SFB": JD._SEG_SFB, "_SEG_WIN": JD._SEG_WIN, "_LB": JD._LB,
        "_MIXED_SPLIT": JD._MIXED_SPLIT, "_REORDER": JHD._REORDER,
        "_BIGLUT": JHD._BIGLUT, "_BIG_BASE": JHD._BIG_BASE,
        "_BIG_WIDTH": JHD._BIG_WIDTH, "_KTID": JHD._KTID, "_KLIN": JHD._KLIN,
        "_KTID_RESERVED": JHD._KTID_RESERVED, "_C1_LO4": JHD._C1_LO4,
        "_C1_LO5": JHD._C1_LO5, "_C1_NIB4": JHD._C1_NIB4,
        "_C1_NIB5": JHD._C1_NIB5, "_C1_NIB6": JHD._C1_NIB6,
    }


NAMES = sorted(_jax_constants())


def test_reference_constants_cover_the_jax_tables():
    assert sorted(PD.reference_constants()) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_reference_constant_equals_jax(name):
    mine = PD.reference_constants()[name]
    ref = _jax_constants()[name]
    if name == "_L2B_VARIANTS":
        assert len(mine) == len(ref)
        for (oh_m, vs_m), (oh_r, vs_r) in zip(mine, ref):
            assert vs_m == vs_r
            assert oh_m.dtype == oh_r.dtype
            np.testing.assert_array_equal(oh_m, oh_r)
        return
    if isinstance(ref, int):
        assert mine == ref
        return
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)
