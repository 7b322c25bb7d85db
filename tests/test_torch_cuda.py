"""PyTorch port on the GPU: each CUDA kernel against its plain torch twin.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without a card.  The module imports only torch, numpy and the port (the
GPU machine has no JAX), and its MP3 inputs are the committed fixtures
under tests/data/torch_port/.  On the GPU machine run it without the
suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch import decode_paths
from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
from audio_decoder_tpu_torch.codecs.mpeg import dsp
from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD
from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
from audio_decoder_tpu_torch.codecs.mpeg import native
from audio_decoder_tpu_torch.ops import synth_kernel as SK

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
FIXTURES = [os.path.join(DATA, f) for f in ("stereo_44k1_128k_js.mp3",
                                            "mono_22k05_lsf.mp3")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _lanes(path: str, dev, corrupt: bool = False):
    """One fixture's scan inputs (decode_spectra's first 11 arguments)."""
    blob = open(path, "rb").read()
    p = native.probe(blob)
    r = native.lanes_batch([blob], D._bucket(p["n_granules"]),
                           D._bucket(p["main_bytes"], 1024), p["channels"])
    if corrupt:
        rng = np.random.default_rng(3)
        m = r["main"]
        flips = rng.integers(0, p["main_bytes"], size=p["main_bytes"] // 2)
        m[0, flips] ^= (1 << rng.integers(0, 8, size=flips.size)).astype(np.uint8)
    n = r["start"].size
    start = r["start"].reshape(n).astype(np.int32)
    cols = [np.zeros(n, np.int32), start, r["end"].reshape(n), r["limit"].reshape(n),
            r["big"].reshape(n), r["r1"].reshape(n), r["r2"].reshape(n),
            r["tsel"].reshape(n, 3), r["c1sel"].reshape(n), r["valid"].reshape(n)]
    t = [torch.as_tensor(np.ascontiguousarray(c, np.int32), device=dev) for c in cols]
    return [torch.as_tensor(r["main"], device=dev)] + t


@pytest.mark.parametrize("path", FIXTURES, ids=["stereo", "lsf"])
@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
@pytest.mark.parametrize("n_big,n_c1", [(512, 144), (64, 40)])
def test_entropy_kernel_matches_plain(cuda_device, path, corrupt, n_big, n_c1):
    args = _lanes(path, cuda_device, corrupt)
    before = HK.launches
    got = HK.entropy_scan(*args, n_big=n_big, n_c1=n_c1)
    assert HK.launches == before + 1
    ref = HD.scan_plain(*args, n_big=n_big, n_c1=n_c1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("seed", range(4))
def test_entropy_kernel_matches_plain_on_random_lanes(cuda_device, seed):
    """Garbage bytes with random side info (start past end, limit before
    end, reserved tables, big_values up to 511, invalid lanes, several
    files per batch)."""
    rng = np.random.default_rng(seed)
    n, files, width = 4096, 3, 16384
    main = rng.integers(0, 256, size=(files, width), dtype=np.uint8)
    start = rng.integers(0, 8 * (width - 2000), size=n)
    end = start + rng.integers(-50, 4000, size=n)
    limit = end + rng.integers(-20, 300, size=n)
    r1 = rng.integers(0, 577, size=n)
    cols = [rng.integers(0, files, size=n), start, end, limit,
            rng.integers(0, 512, size=n), r1,
            np.maximum(r1, rng.integers(0, 577, size=n)),
            rng.integers(0, 32, size=(n, 3)), rng.integers(0, 2, size=n),
            rng.random(n) < 0.9]
    args = [torch.as_tensor(main, device=cuda_device)] + [
        torch.as_tensor(np.ascontiguousarray(c, np.int32), device=cuda_device)
        for c in cols]
    for n_big, n_c1 in ((512, 144), (96, 72)):
        got = HK.entropy_scan(*args, n_big=n_big, n_c1=n_c1)
        ref = HD.scan_plain(*args, n_big=n_big, n_c1=n_c1)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert 0 < int(got[2].sum()) < n


def test_entropy_kernel_reserved_and_invalid_lanes(cuda_device):
    args = _lanes(FIXTURES[0], cuda_device)
    tsel, valid = args[8].clone(), args[10].clone()
    live = torch.nonzero(valid > 0).flatten()
    tsel[live[0], 0] = 4
    tsel[live[1], 1] = 14
    valid[live[2]] = 0
    args[8], args[10] = tsel, valid
    got = HK.entropy_scan(*args)
    ref = HD.scan_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert bool(got[2][live[0]]) and bool(got[2][live[2]])


@pytest.mark.parametrize("T", [1, 63, 64, 65, 1000])
def test_synthesis_kernel_matches_plain(cuda_device, T):
    rng = np.random.default_rng(T)
    c = dsp._consts(cuda_device)
    ts = torch.as_tensor(rng.standard_normal((5, T, 32)).astype(np.float32),
                         device=cuda_device)
    before = SK.launches
    got = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    assert SK.launches == before + 1
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    c = dsp._consts(cuda_device)
    ts = torch.zeros((2, 8, 32), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    args = _lanes(FIXTURES[1], cuda_device)
    args[2] = args[2].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        HK.entropy_scan(*args)


def test_decode_paths_cuda_matches_cpu(cuda_device):
    gpu = decode_paths(FIXTURES, device=cuda_device)
    cpu = decode_paths(FIXTURES, device="cpu")
    assert gpu.data.device.type == "cuda"
    assert gpu.names == cpu.names
    for k in ("sample_rate", "num_channels", "valid_frames", "err"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k))
    for i in range(len(FIXTURES)):
        ref, got = cpu.file(i).pcm, gpu.file(i).pcm
        rms = float(np.sqrt(((ref - got) ** 2).mean()))
        bar = 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
        assert rms < bar, (i, rms, bar)
