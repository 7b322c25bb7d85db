"""The FLAC rice scan's dispatch and its kernel wrapper on the CPU.

CPU tensors run the plain twin ``codecs/flac/device._rice_scan`` with the
decode's mask and never load the kernel's library; a device that is
neither the CPU nor CUDA raises; ``ops/rice_scan.rice_scan_cuda`` refuses
malformed inputs, and tensors off the card, before any library loads.  The kernel itself is held
against the twin on the card (``tests/test_torch_cuda.py``, ``-m cuda``)
on the same ``rice_case`` edges.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch.codecs.flac import decoder as FD
from audio_decoder_tpu_torch.codecs.flac import device as FV
from audio_decoder_tpu_torch.codecs.flac import frontend as FF
from audio_decoder_tpu_torch.ops import rice_scan as RS
from audio_decoder_tpu_torch.utils import build

from .test_torch_cuda import RICE_CASES, flac_music, rice_case, rice_plain


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to load or build the kernel's library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the rice kernel's library was loaded")

    monkeypatch.setattr(RS, "load_library", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)


@pytest.mark.parametrize("cid", RICE_CASES)
def test_cpu_tensors_run_the_twin(cid, no_library):
    case = rice_case(cid)
    before = dict(RS.launches)
    got_v, got_o = FV._rice_lanes(*[torch.as_tensor(a) for a in case[:5]],
                                  *case[5:])
    want_v, want_o = rice_plain(*case)
    assert torch.equal(got_v, want_v) and torch.equal(got_o, want_o)
    assert RS.launches == before and "flac_rice" not in build._libs


def test_a_cpu_wire_decode_launches_nothing(no_library):
    from audio_decoder_tpu_torch.codecs.flac.encode import encode_flac

    rng = np.random.default_rng(3)
    blobs = [encode_flac(flac_music(rng, S), 44100, bits=16, device="cpu")
             for S in (20000, 7000)]
    an = [FF.analyze(b) for b in blobs]
    before = RS.launches["flac_rice"]
    args, statics = FD.pack_wire(an, "cpu")
    pcm, ovf = FV.flac_decode_wire(*args, **statics)
    assert RS.launches["flac_rice"] == before
    assert pcm.device.type == "cpu" and not ovf.any()


def test_another_device_raises(no_library):
    case = rice_case("narrow")
    args = [torch.as_tensor(a).to("meta") for a in case[:5]]
    with pytest.raises(ValueError, match="unsupported device meta"):
        FV._rice_lanes(*args, *case[5:])


def _bad(kind: str):
    """The ``narrow`` case's CPU tensors with one fault."""
    s, b, c, p, lim = [torch.as_tensor(a) for a in rice_case("narrow")[:5]]
    if kind == "stream-dtype":
        s = s.to(torch.int8)
    elif kind == "stream-2d":
        s = s.view(2, -1)
    elif kind == "bitpos-dtype":
        b = b.to(torch.int64)
    elif kind == "count-shape":
        c = c[:-1].contiguous()
    elif kind == "param-strided":
        p = torch.stack([p, p], 1)[:, 0]
    elif kind == "limit-dtype":
        lim = lim.to(torch.int32)
    elif kind == "mixed-devices":
        lim = lim.to("meta")
    return s, b, c, p, lim


#: the ``narrow`` case's steps, variant, codes per step and quotient cap
STATICS = (4, True, FV.rice_k(True), FF.Q_CAP)


@pytest.mark.parametrize("kind,match", [
    ("stream-dtype", "uint8"), ("stream-2d", "uint8"),
    ("bitpos-dtype", "bitpos must be torch.int32"),
    ("count-shape", "count must be"), ("param-strided", "contiguous"),
    ("limit-dtype", "limit must be torch.int64"),
    ("mixed-devices", "one device"), ("cpu-tensors", "CUDA tensors")])
def test_bad_inputs_raise_before_the_library_loads(kind, match, no_library):
    with pytest.raises(ValueError, match=match):
        RS.rice_scan_cuda(*_bad(kind), *STATICS)
    assert "flac_rice" not in build._libs


def test_a_negative_step_count_raises_before_the_library_loads(no_library):
    args = [torch.as_tensor(a) for a in rice_case("narrow")[:5]]
    with pytest.raises(ValueError, match="steps"):
        RS.rice_scan_cuda(*args, -1, *STATICS[1:])


@pytest.mark.parametrize("k,q_cap", [(0, FF.Q_CAP), (9, FF.Q_CAP), (8, -1),
                                     (8, 33)])
def test_bad_statics_raise_before_the_library_loads(k, q_cap, no_library):
    args = [torch.as_tensor(a) for a in rice_case("narrow")[:5]]
    with pytest.raises(ValueError, match="out of range"):
        RS.rice_scan_cuda(*args, 4, True, k, q_cap)
    assert "flac_rice" not in build._libs
