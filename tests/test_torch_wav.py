"""PyTorch port, WAV half: header parse + PCM unpack against the JAX package.

The same bytes go through ``audio_decoder_tpu`` (on the CPU) and
``audio_decoder_tpu_torch`` (device="cpu"); metadata, error codes and PCM
must match exactly.  Each JAX program runs at one static shape per
config: every file is packed into one 1024-byte-wide batch.
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_decoder_tpu.codecs import registry as JR
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu.parallel.decode import decode_pcm_step as j_step
from audio_decoder_tpu_torch.codecs import registry as PR
from audio_decoder_tpu_torch.io.assets import Asset as PAsset
from audio_decoder_tpu_torch.parallel.decode import decode_pcm_step as p_step

from .synth import make_wav

WIDTH = 1024  # packed byte width of every batch in this module


def _pcm(rng, frames, ch, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    return rng.integers(lo, hi, size=(frames, ch), dtype=np.int64)


def _file_cases():
    """(name, bytes) for every WAV flavour the port decodes plus malformed
    headers; all fit WIDTH bytes."""
    rng = np.random.default_rng(0x7A11)
    fl = np.clip(rng.standard_normal((40, 2)) * 0.4, -1, 1)
    g711 = rng.integers(0, 256, size=(60, 1)).astype(np.uint8).tobytes()
    ok16 = make_wav(_pcm(rng, 50, 2, 16), bits=16)
    cases = [
        ("pcm8_mono", make_wav(_pcm(rng, 90, 1, 8), 8000, bits=8)),
        ("pcm16_stereo", ok16),
        ("pcm16_mono_odd", make_wav(_pcm(rng, 33, 1, 16), 22050, bits=16)),
        ("pcm24_stereo", make_wav(_pcm(rng, 40, 2, 24), 48000, bits=24)),
        ("pcm32_stereo", make_wav(_pcm(rng, 30, 2, 32), bits=32)),
        ("float32", make_wav(fl.astype(np.float32), bits=32, float32=True)),
        ("float64", make_wav(fl[:25], bits=64, float64=True)),
        ("alaw", make_wav(np.zeros((60, 1), np.int64), 8000, bits=8,
                          data_override=g711, fmt_code_override=6)),
        ("ulaw", make_wav(np.zeros((60, 1), np.int64), 8000, bits=8,
                          data_override=g711, fmt_code_override=7)),
        ("extensible24", make_wav(_pcm(rng, 20, 2, 24), bits=24,
                                  extensible=True)),
        ("extra_chunks", make_wav(_pcm(rng, 20, 2, 16), bits=16,
                                  extra_chunks=[(b"LIST", b"abc"),
                                                (b"fact", struct.pack("<I", 20))])),
        ("rf64", make_wav(_pcm(rng, 20, 2, 16), bits=16, rf64=True,
                          rf64_sample_count=20)),
        ("truncated", ok16[:-17]),
        ("bad_magic", b"RIFX" + ok16[4:]),
        ("no_data", ok16[:36]),
        ("short", ok16[:10]),
        ("fmt_code_99", make_wav(_pcm(rng, 10, 1, 16), bits=16,
                                 fmt_code_override=99)),
        ("zero_channels", make_wav(np.zeros((10, 1), np.int64), bits=16)[:22]
         + b"\x00\x00" + make_wav(np.zeros((10, 1), np.int64), bits=16)[24:]),
        ("pcm12", make_wav(np.zeros((10, 1), np.int64), bits=16)[:34]
         + struct.pack("<H", 12) + make_wav(np.zeros((10, 1), np.int64),
                                            bits=16)[36:]),
        ("huge_chunk", ok16[:12] + b"junk" + struct.pack("<I", 0x7FFFFFF0)
         + ok16[12:]),
        ("odd_pad_chunk", make_wav(_pcm(rng, 12, 1, 16), bits=16,
                                   extra_chunks=[(b"odd ", b"x")])),
    ]
    for name, blob in cases:
        assert len(blob) <= WIDTH, name
    return cases


CASES = _file_cases()


@pytest.fixture(scope="module")
def family_results():
    """Both packages' decode_pcm_family over every case in one batch."""
    j_assets = [JAsset(path=n + ".wav", name=n, ext="wav", data=b)
                for n, b in CASES]
    p_assets = [PAsset(path=n + ".wav", name=n, ext="wav", data=b)
                for n, b in CASES]
    j = {}
    for idxs, batch in JR.decode_pcm_family("wav", j_assets):
        for row, i in enumerate(idxs):
            j[CASES[i][0]] = batch.file(row)
    p = {}
    for idxs, batch in PR.decode_pcm_family("wav", p_assets, device="cpu"):
        assert batch.data.device.type == "cpu"
        for row, i in enumerate(idxs):
            p[CASES[i][0]] = batch.file(row)
    return j, p


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_decode_pcm_family_matches_jax(family_results, name):
    j, p = family_results
    a, b = j[name], p[name]
    assert (a.err, a.sample_rate, a.num_channels, a.bits_per_sample,
            a.format) == (b.err, b.sample_rate, b.num_channels,
                          b.bits_per_sample, b.format)
    assert a.pcm.shape == b.pcm.shape
    np.testing.assert_array_equal(a.pcm, b.pcm)


def test_malformed_cases_carry_error_codes(family_results):
    _j, p = family_results
    for name in ("truncated", "bad_magic", "no_data", "short", "fmt_code_99",
                 "zero_channels", "pcm12", "huge_chunk"):
        assert p[name].err != 0, name
    for name in ("pcm16_stereo", "float64", "alaw", "rf64", "odd_pad_chunk"):
        assert p[name].err == 0, name


@pytest.mark.parametrize("bits,channels", [(8, 1), (16, 2), (24, 2), (32, 1)])
def test_decode_pcm_step_matches_jax(bits, channels):
    rng = np.random.default_rng(bits * 10 + channels)
    blobs = [
        make_wav(_pcm(rng, 64, channels, bits), bits=bits),
        make_wav(_pcm(rng, 17, channels, bits), bits=bits),
        make_wav(_pcm(rng, 20, 3 - channels, bits), bits=bits),  # geometry
        make_wav(_pcm(rng, 20, channels, 16 if bits != 16 else 24),
                 bits=16 if bits != 16 else 24),                  # geometry
        b"RIFF\x00\x00",                                          # garbage
    ]
    bufs = np.zeros((len(blobs), WIDTH), np.uint8)
    lens = np.zeros((len(blobs),), np.int32)
    for i, b in enumerate(blobs):
        bufs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    kw = dict(bits=bits, channels=channels, max_frames=128)
    j_pcm, j_meta = j_step(jnp.asarray(bufs), jnp.asarray(lens), **kw)
    p_pcm, p_meta = p_step(torch.as_tensor(bufs), torch.as_tensor(lens), **kw)
    np.testing.assert_array_equal(np.asarray(j_pcm), p_pcm.numpy())
    assert set(j_meta) == set(p_meta)
    for k in j_meta:
        np.testing.assert_array_equal(np.asarray(j_meta[k]), p_meta[k].numpy(),
                                      err_msg=k)
    assert p_meta["err"][0] == 0 and all(p_meta["err"][2:] != 0)


def test_decode_pcm_step_families_match_jax():
    """The step parses with the family it is given: WAV and AIFF files in
    one batch, once as "wav" and once as "aiff"; each family decodes its
    own files and flags the other's, as in JAX."""
    from .synth import make_aiff

    rng = np.random.default_rng(0xF0)
    blobs = [make_wav(_pcm(rng, 40, 2, 16), bits=16),
             make_aiff(_pcm(rng, 30, 2, 16), 44100, 16),
             make_aiff(_pcm(rng, 20, 2, 16), 44100, 16, compression=b"sowt")]
    bufs = np.zeros((len(blobs), WIDTH), np.uint8)
    lens = np.zeros((len(blobs),), np.int32)
    for i, b in enumerate(blobs):
        bufs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    for family, ok in (("wav", [0]), ("aiff", [1])):
        kw = dict(bits=16, channels=2, max_frames=64, family=family)
        j_pcm, j_meta = j_step(jnp.asarray(bufs), jnp.asarray(lens), **kw)
        p_pcm, p_meta = p_step(torch.as_tensor(bufs), torch.as_tensor(lens),
                               **kw)
        np.testing.assert_array_equal(np.asarray(j_pcm), p_pcm.numpy())
        for k in j_meta:
            np.testing.assert_array_equal(np.asarray(j_meta[k]),
                                          p_meta[k].numpy(), err_msg=k)
        assert [i for i in range(3) if p_meta["err"][i] == 0] == ok


def test_ima_adpcm_decodes_like_jax():
    ima = make_wav(np.zeros((1, 1), np.int64), bits=4, fmt_code_override=0x11,
                   block_align_override=36,
                   fmt_tail=struct.pack("<HH", 2, 65),
                   data_override=bytes(range(7, 79, 2)))
    j = JR.decode_pcm_family(
        "wav", [JAsset(path="ima.wav", name="ima", ext="wav", data=ima)])
    p = PR.decode_pcm_family(
        "wav", [PAsset(path="ima.wav", name="ima", ext="wav", data=ima)],
        device="cpu")
    a, b = j[0][1].file(0), p[0][1].file(0)
    assert a.err == b.err == 0 and b.pcm.shape == (65, 1)
    assert (a.sample_rate, a.bits_per_sample) == (b.sample_rate,
                                                  b.bits_per_sample)
    np.testing.assert_array_equal(a.pcm, b.pcm)
