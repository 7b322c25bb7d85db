"""PyTorch port, the ADPCM unpackers (WAV IMA, WAV MS, Apple ima4 in AIFF-C
and CAF) against the JAX package and the numpy reference decoders.

Encoded files go through ``decode_pcm_family`` of both packages (on the
CPU; the port with device="cpu"): PCM must be bit-equal to JAX's and,
times 32768, to ``tests/ima_ref.py``/``ms_ref.py``'s decoders, partial
last blocks included.  The unpackers are also held against JAX's on
random bytes (any header, any nibble) and at the edges of the data
region.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_decoder_tpu.codecs import registry as JR
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu.ops import unpack as JU
from audio_decoder_tpu_torch.codecs import registry as PR
from audio_decoder_tpu_torch.io.assets import Asset as PAsset
from audio_decoder_tpu_torch.ops import unpack as PU

from . import ima_ref as IR
from . import ms_ref as MR
from .seeded_writers import ima_spb, ima_wav, ms_spb, ms_wav
from .synth import make_aiff, make_caf


def _signal(rng, frames, ch):
    """Tone + noise: small and large steps."""
    t = np.arange(frames)
    s = 12000 * np.sin(2 * np.pi * 220 * t / 44100)
    s = s[:, None] * (1.0 - 0.3 * np.arange(ch)[None, :])
    s = s + rng.normal(0, 900, size=(frames, ch))
    return np.clip(s, -32768, 32767).astype(np.int16)


def _cases():
    """(name, ext, bytes, reference int16 PCM) for every ADPCM flavour."""
    rng = np.random.default_rng(0xADC)
    out = []
    for ch, ba in ((1, 256), (2, 256), (2, 512), (1, 1024)):
        data = IR.encode(_signal(rng, 2 * ima_spb(ba, ch) + 7, ch), ba)
        out.append((f"ima_c{ch}_ba{ba}", "wav", ima_wav(data, ch, ba),
                    IR.decode(data, ch, ba)))
    # partial last blocks: header + two word groups; header only
    ch, ba = 2, 256
    data = IR.encode(_signal(rng, 3 * ima_spb(ba, ch), ch), ba)
    for tag, cut in (("words", len(data) - ba + 12 * ch),
                     ("header", len(data) - ba + 4 * ch)):
        out.append((f"ima_partial_{tag}", "wav", ima_wav(data[:cut], ch, ba),
                    IR.decode(data[:cut], ch, ba)))
    frames = 2 * ima_spb(512, 1) + 11
    data = IR.encode(_signal(rng, frames, 1), 512)
    out.append(("ima_fact", "wav", ima_wav(data, 1, 512, fact=frames),
                IR.decode(data, 1, 512, n_frames=frames)))
    out.append(("ima_extensible", "wav",
                ima_wav(data, 1, 512, extensible=True), IR.decode(data, 1, 512)))

    for ch, ba in ((1, 256), (2, 256), (2, 512)):
        data = MR.encode(_signal(rng, 2 * ms_spb(ba, ch) + 5, ch), ba)
        out.append((f"ms_c{ch}_ba{ba}", "wav", ms_wav(data, ch, ba),
                    MR.decode(data, ch, ba)))
    for ch in (1, 2):
        ba = 256
        data = MR.encode(_signal(rng, 3 * ms_spb(ba, ch), ch), ba)
        cut = len(data) - ba + 7 * ch + 10  # header + 10 code bytes
        out.append((f"ms_partial_c{ch}", "wav", ms_wav(data[:cut], ch, ba),
                    MR.decode(data[:cut], ch, ba)))
    frames = 2 * ms_spb(256, 2) + 9
    data = MR.encode(_signal(rng, frames, 2), 256)
    out.append(("ms_fact", "wav", ms_wav(data, 2, 256, fact=frames),
                MR.decode(data, 2, 256, n_frames=frames)))

    for ch in (1, 2):
        frames = 5 * 64 + 17  # COMM's frame count trims the last packet
        data = IR.encode_ima4(_signal(rng, frames, ch))
        out.append((f"ima4_aifc_c{ch}", "aifc", make_aiff(
            np.zeros((0, ch), np.int16), 44100, 16, compression=b"ima4",
            data_override=data, frames_override=frames),
            IR.decode_ima4(data, ch, n_frames=frames)))
        data = IR.encode_ima4(_signal(rng, 4 * 64, ch))
        out.append((f"ima4_caf_c{ch}", "caf", make_caf(
            np.zeros((0, ch), np.int64), 22050, codec=b"ima4",
            data_override=data + b"\x00" * 20),  # a part-packet tail
            IR.decode_ima4(data, ch)))
    return out


CASES = _cases()
FAMILY = {"wav": "wav", "aifc": "aiff", "caf": "caf"}


@pytest.fixture(scope="module")
def decoded():
    """{name: (jax file, port file)}, one decode_pcm_family per family."""
    out = {}
    for ext, fam in FAMILY.items():
        cases = [c for c in CASES if c[1] == ext]
        j = JR.decode_pcm_family(fam, [JAsset(f"{n}.{ext}", n, ext, b)
                                       for n, _, b, _ in cases])
        p = PR.decode_pcm_family(fam, [PAsset(f"{n}.{ext}", n, ext, b)
                                       for n, _, b, _ in cases], device="cpu")
        jf = {cases[i][0]: bt.file(r) for ix, bt in j for r, i in enumerate(ix)}
        pf = {cases[i][0]: bt.file(r) for ix, bt in p for r, i in enumerate(ix)}
        for n, *_ in cases:
            out[n] = (jf[n], pf[n])
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_adpcm_file_matches_jax_and_reference(decoded, name):
    ref = next(c[3] for c in CASES if c[0] == name)
    a, b = decoded[name]
    assert a.err == b.err == 0
    assert (a.sample_rate, a.num_channels, a.bits_per_sample) == (
        b.sample_rate, b.num_channels, b.bits_per_sample)
    assert a.pcm.shape == b.pcm.shape == ref.shape
    np.testing.assert_array_equal(a.pcm, b.pcm)
    np.testing.assert_array_equal(
        np.round(b.pcm * 32768.0).astype(np.int16), ref)


def _random_region(seed, B, width):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(B, width), dtype=np.uint8)


def _both(jfn, pfn, bufs, off, nf, **kw):
    j = np.asarray(jfn(jnp.asarray(bufs), jnp.asarray(off), jnp.asarray(nf),
                       **kw))
    p = pfn(torch.as_tensor(bufs), torch.as_tensor(off), torch.as_tensor(nf),
            **kw)
    assert p.dtype == torch.float32
    return j, p.numpy()


@pytest.mark.parametrize("channels,block_align", [(1, 36), (2, 72), (2, 40)])
def test_ima_unpacker_on_random_bytes(channels, block_align):
    """Any predictor, any step index (clamped to 88), any nibble, and data
    offsets at the edges: 0, inside, near the end, past it, negative."""
    B, width = 6, 600
    bufs = _random_region(channels * 100 + block_align, B, width)
    off = np.array([0, 13, width - 50, width - 3, width + 40, -5], np.int32)
    spb = 1 + 8 * ((block_align - 4 * channels) // (4 * channels))
    nf = np.array([5 * spb, 3 * spb + 1, 2 * spb, spb, 4 * spb, 7], np.int32)
    kw = dict(channels=channels, block_align=block_align, max_frames=256)
    j, p = _both(JU.unpack_ima_adpcm, PU.unpack_ima_adpcm, bufs, off, nf, **kw)
    np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("channels,block_align", [(1, 30), (2, 44)])
def test_ms_unpacker_on_random_bytes(channels, block_align):
    """Any coefficient index (clamped to 6), negative and huge idelta
    (int32 products wrap alike), any code, edge offsets."""
    B, width = 6, 500
    bufs = _random_region(channels * 7 + block_align, B, width)
    off = np.array([0, 7, width - 40, width - 1, width + 9, -2], np.int32)
    nf = np.full(B, 200, np.int32)
    kw = dict(channels=channels, block_align=block_align, max_frames=256)
    j, p = _both(JU.unpack_ms_adpcm, PU.unpack_ms_adpcm, bufs, off, nf, **kw)
    np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("channels", [1, 2])
def test_ima4_unpacker_on_random_bytes(channels):
    B, width = 5, 800
    bufs = _random_region(40 + channels, B, width)
    off = np.array([0, 3, width - 100, width + 1, -7], np.int32)
    nf = np.array([256, 200, 64, 128, 256], np.int32)
    kw = dict(channels=channels, max_frames=256)
    j, p = _both(JU.unpack_ima4, PU.unpack_ima4, bufs, off, nf, **kw)
    np.testing.assert_array_equal(j, p)


def test_ima_step_tables_fold_the_nibble_arithmetic():
    """The port's per-(index, nibble) tables equal the JAX scan's
    per-nibble arithmetic at every state."""
    steps, itab = JU._IMA_STEPS.astype(np.int64), JU._IMA_INDEX
    for idx in range(89):
        for d in range(16):
            step = steps[idx]
            vp = ((step >> 3) + (step if d & 4 else 0)
                  + ((step >> 1) if d & 2 else 0) + ((step >> 2) if d & 1 else 0))
            assert PU._IMA_DELTA[16 * idx + d] == (-vp if d & 8 else vp)
            assert PU._IMA_NEXT16[16 * idx + d] == 16 * min(max(
                idx + itab[d], 0), 88)


@pytest.mark.parametrize("fn,kw", [
    (PU.unpack_ima_adpcm, dict(block_align=35)),
    (PU.unpack_ima_adpcm, dict(block_align=8)),
    (PU.unpack_ms_adpcm, dict(block_align=14)),
])
def test_bad_block_geometry_raises(fn, kw):
    bufs = torch.zeros((1, 64), dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_align"):
        fn(bufs, z, z, channels=2, max_frames=16, **kw)
