"""PyTorch port: imports without JAX, builds from its own sources, and
carries the JAX package's constant tables exactly."""

import ast
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


def _docstrings(tree: ast.AST) -> set[int]:
    """ids of the string constants that are docstrings."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


#: a ``file:line`` citation of a TPU kernel (chip_smoke.py's ``replaces``)
_CITATION = re.compile(r"audio_decoder_tpu/[\w/]+\.py:\d+")


def _paths_into_jax_package(path: pathlib.Path) -> list[str]:
    """String constants in a Python file that name a path inside the JAX
    package (docstrings, ``file:line`` citations of the TPU kernels and the
    comment lines of generated C headers aside)."""
    tree = ast.parse(path.read_text())
    allowed = _docstrings(tree)
    hits = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in allowed and not node.value.startswith("//")
                and not _CITATION.fullmatch(node.value)
                and re.search(r"\baudio_decoder_tpu(/|$)", node.value)):
            hits.append(f"{path.relative_to(REPO)}:{node.lineno}: {node.value!r}")
    return hits


def test_no_path_into_the_jax_package():
    """The port builds and reads only its own files: no string in its
    package or in chip_smoke.py names a path inside audio_decoder_tpu/
    (chip_smoke.py cites each TPU kernel's file:line in ``replaces``)."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [h for p in files for h in _paths_into_jax_package(p)]
    assert hits == []


@pytest.mark.parametrize("name", ["mp3fe.cc", "flacfe.cc"])
def test_native_sources_are_copies(name):
    """The port's C++ front-ends equal the JAX package's sources once the
    first line, which names the source, is removed."""
    mine = (PKG / "native" / name).read_bytes()
    first, rest = mine.split(b"\n", 1)
    assert first.startswith(b"// ") and f"audio_decoder_tpu/native/{name}".encode() in first
    assert rest == (REPO / "audio_decoder_tpu" / "native" / name).read_bytes()


#: the port's Python modules copied verbatim from the JAX package (it
#: imports jax on import; these modules do not)
PY_COPIES = ["core/errors.py", "io/assets.py", "codecs/flac/host.py",
             "codecs/mpeg/tables.py", "codecs/mpeg/huffman_tables.py",
             "codecs/mpeg/synth_window.py", "codecs/mpeg/frontend.py",
             "codecs/mpeg/layer12_tables.py"]


@pytest.mark.parametrize("rel", PY_COPIES)
def test_python_copies_are_verbatim(rel):
    """Each copy equals its source in the JAX package byte for byte once
    the first line, which names the source, is removed."""
    first, rest = (PKG / rel).read_bytes().split(b"\n", 1)
    assert first.startswith(b"# Verbatim copy of ")
    assert f"audio_decoder_tpu/{rel} ".encode() in first
    assert rest == (REPO / "audio_decoder_tpu" / rel).read_bytes()


def test_generated_huffman_header_equals_the_committed_one(tmp_path):
    """utils/gen_luts writes huffman_lut.h from the port's own tables, byte
    for byte the JAX package's committed header."""
    from audio_decoder_tpu_torch.utils import gen_luts

    path = gen_luts.huffman_lut_header(str(tmp_path))
    assert path.startswith(str(tmp_path))
    ref = (REPO / "audio_decoder_tpu" / "native" / "huffman_lut.h").read_bytes()
    assert pathlib.Path(path).read_bytes() == ref
    assert gen_luts.huffman_lut_header(str(tmp_path)) == path  # reused


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
