"""The FLAC predictor's dispatch and its kernel wrapper on the CPU.

CPU tensors run the plain twin ``codecs/flac/device._predict`` and never
load the kernel's library; a device that is neither the CPU nor CUDA
raises; ``ops/flac_predict.predict_cuda`` refuses malformed inputs, and
tensors off the card, before any library loads, and hands a stand-in
library the decode's strided view as it is.  The kernel itself is held
against the twin on the card (``tests/test_torch_cuda.py``, ``-m cuda``)
on the same ``predict_case`` edges.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch.codecs.flac import decoder as FD
from audio_decoder_tpu_torch.codecs.flac import device as FV
from audio_decoder_tpu_torch.codecs.flac import frontend as FF
from audio_decoder_tpu_torch.ops import flac_predict as PP
from audio_decoder_tpu_torch.utils import build
from audio_decoder_tpu_torch.utils.trace import TRACE

from .test_torch_cuda import decode_view, flac_music, predict_case


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to load or build the kernel's library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the predictor kernel's library was loaded")

    monkeypatch.setattr(PP, "load_library", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def predict_numpy(vals, kind, order, shift, wasted, coeffs) -> np.ndarray:
    """The recurrence written out in numpy int64, one sample position at a
    time over every subframe, with int32 wrapping made explicit."""
    Ls, nmax = vals.shape
    v = vals.astype(np.int64)
    s = np.zeros((Ls, 32 + nmax), np.int64)  # 32 samples of zero history
    c = coeffs.astype(np.int64)
    for i in range(nmax):
        hist = s[:, i:i + 32][:, ::-1]  # hist[:, j] = s[i-1-j]
        pred = _wrap32((c * hist).sum(1) >> shift.astype(np.int64))
        s[:, 32 + i] = np.where(i < order, v[:, i], _wrap32(pred + v[:, i]))
    out = np.where(kind[:, None] == 1, v[:, :1], s[:, 32:])
    return _wrap32(out << wasted[:, None].astype(np.int64)).astype(np.int32)


@pytest.mark.parametrize("nmax", (1, 16, 1152))
def test_cpu_tensors_run_the_twin(nmax, no_library):
    case = predict_case(nmax)
    t = [torch.as_tensor(a) for a in case]
    before = dict(PP.launches)
    got = FV._predict_lanes(decode_view(t[0]), *t[1:], nmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), predict_numpy(*case))
    assert PP.launches == before and "flac_predict" not in build._libs


def test_a_cpu_wire_decode_launches_nothing(no_library):
    from audio_decoder_tpu_torch.codecs.flac.encode import encode_flac

    rng = np.random.default_rng(25)
    blobs = [encode_flac(flac_music(rng, S), 44100, bits=16, device="cpu")
             for S in (9000, 5000)]
    an = [FF.analyze(b) for b in blobs]
    before = PP.launches["flac_predict"]
    args, statics = FD.pack_wire(an, "cpu")
    pcm, ovf = FV.flac_decode_wire(*args, **statics)
    assert PP.launches["flac_predict"] == before
    assert pcm.device.type == "cpu" and not ovf.any()


def test_another_device_raises(no_library):
    args = [torch.as_tensor(a).to("meta") for a in predict_case(16)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        FV._predict_lanes(*args, 16)


def _bad(kind: str):
    """``predict_case(16)``'s CPU tensors, vals as the decode's view, with
    one fault."""
    vals, k, o, s, w, c = [torch.as_tensor(a) for a in predict_case(16)]
    vals = decode_view(vals)
    if kind == "vals-dtype":
        vals = vals.to(torch.int64)
    elif kind == "vals-1d":
        vals = vals[0].contiguous()
    elif kind == "inner-stride":
        vals = torch.stack([vals, vals], 2)[:, :, 0]
    elif kind == "row-stride":
        vals = torch.as_strided(vals, vals.shape, (8, 1))
    elif kind == "order-shape":
        o = o[:-1].contiguous()
    elif kind == "shift-dtype":
        s = s.to(torch.int64)
    elif kind == "wasted-strided":
        w = torch.stack([w, w], 1)[:, 0]
    elif kind == "coeffs-shape":
        c = c[:, :16].contiguous()
    elif kind == "mixed-devices":
        k = k.to("meta")
    return vals, k, o, s, w, c


@pytest.mark.parametrize("kind,match", [
    ("vals-dtype", "vals must be int32"), ("vals-1d", "vals must be int32"),
    ("inner-stride", "unit inner stride"), ("row-stride", "rows overlap"),
    ("order-shape", "order must be int32"),
    ("shift-dtype", "shift must be int32"), ("wasted-strided", "contiguous"),
    ("coeffs-shape", "coeffs must be"), ("mixed-devices", "one device"),
    ("cpu-tensors", "CUDA tensors")])
def test_bad_inputs_raise_before_the_library_loads(kind, match, no_library):
    with pytest.raises(ValueError, match=match):
        PP.predict_cuda(*_bad(kind))
    assert "flac_predict" not in build._libs


class _StandIn:
    """A library with the kernel's interface that records its arguments and
    returns ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc = rc
        self.args = None

    def flac_predict_launch(self, *args):
        self.args = args
        return self.rc


def test_the_launch_gets_the_decode_view_as_it_is(no_library):
    vals, *rest = [torch.as_tensor(a) for a in predict_case(16)]
    view = decode_view(vals)
    lib = _StandIn()
    before = PP.launches["flac_predict"]
    items = TRACE.stats["flac.predict_kernel"].items
    out = PP.predict_cuda(view, *rest, lib=lib, cuda_stream=0)
    ptr, row_stride, *ptrs, n_rows, nmax, out_ptr, stream = lib.args
    assert (ptr, row_stride) == (view.data_ptr(), 17)  # no copy
    assert ptrs == [t.data_ptr() for t in rest]
    assert (n_rows, nmax, out_ptr, stream) == (147, 16, out.data_ptr(), 0)
    assert out.shape == (147, 16) and out.is_contiguous()
    assert PP.launches["flac_predict"] == before + 1
    assert TRACE.stats["flac.predict_kernel"].items == items + 147


def test_a_failed_launch_raises_and_counts_nothing(no_library):
    args = [torch.as_tensor(a) for a in predict_case(16)]
    before = PP.launches["flac_predict"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PP.predict_cuda(*args, lib=_StandIn(700), cuda_stream=0)
    assert PP.launches["flac_predict"] == before
