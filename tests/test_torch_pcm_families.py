"""PyTorch port, the AIFF/AIFF-C, Sun AU and CAF families against the JAX
package.

The same bytes go through ``audio_decoder_tpu`` (on the CPU) and
``audio_decoder_tpu_torch`` (device="cpu"): ``parse_meta_batch`` meta must
match exactly, ``decode_pcm_family`` PCM bit for bit, error codes exactly,
and ``decode_pcm_step(family="aiff")`` both ways.  Each family's files are
packed into one batch, so each JAX program runs at one static shape.
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_decoder_tpu.codecs import aiff as JAIFF
from audio_decoder_tpu.codecs import au as JAU
from audio_decoder_tpu.codecs import caf as JCAF
from audio_decoder_tpu.codecs import registry as JR
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu.io.assets import pack_bytes
from audio_decoder_tpu.parallel.decode import decode_pcm_step as j_step
from audio_decoder_tpu_torch.codecs import aiff as PAIFF
from audio_decoder_tpu_torch.codecs import au as PAU
from audio_decoder_tpu_torch.codecs import caf as PCAF
from audio_decoder_tpu_torch.codecs import registry as PR
from audio_decoder_tpu_torch.core import errors as E
from audio_decoder_tpu_torch.io.assets import Asset as PAsset
from audio_decoder_tpu_torch.ops import bytes as PB
from audio_decoder_tpu_torch.parallel.decode import decode_pcm_step as p_step

from . import ima_ref as IR
from .synth import make_aiff, make_au, make_caf

EXT = {"aiff": "aif", "au": "au", "caf": "caf"}
PARSERS = {"aiff": (JAIFF, PAIFF), "au": (JAU, PAU), "caf": (JCAF, PCAF)}


def _ints(rng, frames, ch, bits):
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(frames, ch))


def _floats(rng, frames, ch):
    return np.clip(rng.standard_normal((frames, ch)) * 0.4, -1, 1)


def _ima4(rng, frames, ch):
    pcm = np.clip(rng.standard_normal((frames, ch)) * 9000, -32768,
                  32767).astype(np.int16)
    return IR.encode_ima4(pcm)


def _aiff_cases(rng):
    g711 = rng.integers(0, 256, size=120).astype(np.uint8).tobytes()
    z1 = np.zeros((0, 1), np.int64)
    ok16 = make_aiff(_ints(rng, 60, 2, 16), 44100, 16)
    return [
        ("pcm8_mono", make_aiff(_ints(rng, 70, 1, 8), 8000, 8)),
        ("pcm16_stereo", ok16),
        ("pcm24_stereo", make_aiff(_ints(rng, 40, 2, 24), 48000, 24)),
        ("pcm32_mono", make_aiff(_ints(rng, 33, 1, 32), 96000, 32)),
        ("aifc_none", make_aiff(_ints(rng, 30, 2, 16), 22050, 16,
                                compression=b"NONE")),
        ("aifc_twos", make_aiff(_ints(rng, 30, 1, 16), 22050, 16,
                                compression=b"twos")),
        ("sowt16", make_aiff(_ints(rng, 50, 2, 16), 44100, 16,
                             compression=b"sowt")),
        ("sowt24", make_aiff(_ints(rng, 20, 1, 24), 44100, 24,
                             compression=b"sowt")),
        ("fl32", make_aiff(_floats(rng, 40, 2), 44100, 32,
                           compression=b"fl32")),
        ("FL64", make_aiff(_floats(rng, 25, 1), 44100, 64,
                           compression=b"FL64")),
        ("ulaw", make_aiff(z1, 8000, 16, compression=b"ulaw",
                           data_override=g711, frames_override=120)),
        ("alaw8", make_aiff(z1, 8000, 8, compression=b"alaw",
                            data_override=g711, frames_override=120)),
        ("ima4_stereo", make_aiff(np.zeros((0, 2), np.int64), 22050, 16,
                                  compression=b"ima4",
                                  data_override=_ima4(rng, 128, 2),
                                  frames_override=128)),
        ("odd_rate_half", make_aiff(_ints(rng, 20, 1, 16), 11025.5, 16)),
        ("odd_rate_frac", make_aiff(_ints(rng, 20, 1, 16), 44100.3, 16)),
        ("ssnd_offset", make_aiff(_ints(rng, 20, 2, 16), 44100, 16,
                                  ssnd_offset=12)),
        ("extra_chunks", make_aiff(_ints(rng, 20, 2, 16), 44100, 16,
                                   extra_chunks=[(b"NAME", b"odd"),
                                                 (b"ANNO", b"note")])),
        ("ssnd_negative_offset", ok16[:46] + struct.pack(">I", 0xFFFFFF00)
         + ok16[50:]),
        ("comm_frames_short", make_aiff(_ints(rng, 40, 1, 16), 44100, 16,
                                        frames_override=25)),
        ("truncated", ok16[:-21]),
        ("bad_magic", b"FORX" + ok16[4:]),
        ("no_ssnd", ok16[:38]),
        ("short", ok16[:10]),
        ("bad_comm_size", make_aiff(_ints(rng, 10, 1, 16), 44100, 16,
                                    comm_size=20)),
        ("unsupported_comp", make_aiff(_ints(rng, 10, 1, 16), 44100, 16,
                                       compression=b"ACE2")),
        ("pcm12", make_aiff(_ints(rng, 10, 1, 16), 44100, 16)[:26]
         + struct.pack(">h", 12)
         + make_aiff(_ints(rng, 10, 1, 16), 44100, 16)[28:]),
        ("zero_rate", make_aiff(_ints(rng, 10, 1, 16), 0, 16)),
        ("zero_channels", make_aiff(np.zeros((10, 0), np.int64), 44100,
                                    16)),
    ]


def _au_cases(rng):
    g711 = rng.integers(0, 256, size=90).astype(np.uint8).tobytes()
    z1 = np.zeros((0, 1), np.int64)
    ok16 = make_au(_ints(rng, 40, 2, 16), 44100, 3)
    return [
        ("ulaw", make_au(z1, 8000, 1, data_override=g711)),
        ("pcm8", make_au(_ints(rng, 60, 1, 8), 8000, 2)),
        ("pcm16", ok16),
        ("pcm24", make_au(_ints(rng, 30, 2, 24), 48000, 4)),
        ("pcm32", make_au(_ints(rng, 30, 1, 32), 44100, 5)),
        ("float32", make_au(_floats(rng, 30, 2), 44100, 6)),
        ("float64", make_au(_floats(rng, 20, 1), 44100, 7)),
        ("alaw", make_au(z1, 8000, 27, data_override=g711)),
        ("unknown_size", make_au(_ints(rng, 30, 2, 16), 22050, 3,
                                 data_size_override=0xFFFFFFFF)),
        ("oversized", make_au(_ints(rng, 30, 1, 16), 22050, 3,
                              data_size_override=1 << 20)),
        ("annotation", make_au(_ints(rng, 30, 1, 16), 22050, 3,
                               data_offset=40)),
        ("bad_magic", b".snx" + ok16[4:]),
        ("short", ok16[:20]),
        ("offset_past_eof", make_au(_ints(rng, 4, 1, 16), 8000, 3,
                                    data_offset=4000)[:200]),
        ("encoding_23", make_au(z1, 8000, 23, data_override=g711)),
        ("zero_channels", make_au(np.zeros((10, 0), np.int64), 8000, 3)),
        ("offset_in_header", make_au(_ints(rng, 4, 1, 16), 8000, 3)[:4]
         + struct.pack(">I", 16) + make_au(_ints(rng, 4, 1, 16), 8000, 3)[8:]),
    ]


def _caf_cases(rng):
    g711 = rng.integers(0, 256, size=100).astype(np.uint8).tobytes()
    z2 = np.zeros((0, 2), np.int64)
    ok16 = make_caf(_ints(rng, 50, 2, 16), 44100, bits=16)
    rate_word = ok16[:20], ok16[28:]  # desc payload starts at byte 20
    return [
        ("int16_be", ok16),
        ("int24_le", make_caf(_ints(rng, 30, 2, 24), 48000, bits=24,
                              little=True)),
        ("int32_be", make_caf(_ints(rng, 30, 1, 32), 96000, bits=32)),
        ("int8", make_caf(_ints(rng, 40, 1, 8), 8000, bits=8)),
        ("f32_le", make_caf(_floats(rng, 30, 2), 32000, bits=32,
                            little=True, float_=True)),
        ("f64_be", make_caf(_floats(rng, 20, 1), 44100, bits=64,
                            float_=True)),
        ("ulaw", make_caf(np.zeros((0, 1), np.int64), 8000, codec=b"ulaw",
                          data_override=g711)),
        ("alaw_stereo", make_caf(z2, 8000, codec=b"alaw",
                                 data_override=g711)),
        ("ima4", make_caf(np.zeros((0, 1), np.int64), 22050, codec=b"ima4",
                          data_override=_ima4(rng, 192, 1))),
        ("to_eof", make_caf(_ints(rng, 40, 2, 16), 44100, bits=16,
                            data_size_to_eof=True)),
        ("free_chunk", make_caf(_ints(rng, 40, 2, 16), 44100, bits=16,
                                extra_chunks=[(b"free", b"\0" * 17)])),
        ("rate_half_even", make_caf(_ints(rng, 10, 1, 16), 22050.5, bits=16)),
        ("rate_frac", make_caf(_ints(rng, 10, 1, 16), 44100.7, bits=16)),
        ("rate_inf", rate_word[0] + b"\x7f\xf0" + bytes(6) + rate_word[1]),
        ("rate_nan", rate_word[0] + b"\x7f\xf8" + bytes(5) + b"\x01"
         + rate_word[1]),
        ("rate_negative", rate_word[0] + b"\xc0\xe5\x88\x80" + bytes(4)
         + rate_word[1]),
        ("rate_huge", rate_word[0] + b"\x47\xe5\x88\x80" + bytes(4)
         + rate_word[1]),
        ("truncated", ok16[:-37]),
        ("bad_magic", b"WRNG" + ok16[4:]),
        ("no_data", ok16[:52]),
        ("codec_aac", make_caf(_ints(rng, 10, 1, 16), 44100, codec=b"aac ",
                               data_override=b"x" * 64)),
        ("packed_mismatch", ok16[:36] + struct.pack(">I", 6) + ok16[40:]),
        ("size_high_word", ok16[:56] + b"\x00\x00\x00\x01" + ok16[60:]),
    ]


def _cases():
    rng = np.random.default_rng(0xA1FF)
    return {"aiff": _aiff_cases(rng), "au": _au_cases(rng),
            "caf": _caf_cases(rng)}


CASES = _cases()
IDS = [(fam, name) for fam, cases in CASES.items() for name, _ in cases]


def _packed(fam):
    bufs, lens = pack_bytes([b for _, b in CASES[fam]])
    return bufs, lens


@pytest.fixture(scope="module")
def family_results():
    """Both packages' decode_pcm_family over each family's cases, one
    batch per family: {(family, name): (jax file, port file)}."""
    out = {}
    for fam, cases in CASES.items():
        ext = EXT[fam]
        j_assets = [JAsset(path=f"{n}.{ext}", name=n, ext=ext, data=b)
                    for n, b in cases]
        p_assets = [PAsset(path=f"{n}.{ext}", name=n, ext=ext, data=b)
                    for n, b in cases]
        j, p = {}, {}
        for idxs, batch in JR.decode_pcm_family(fam, j_assets):
            for row, i in enumerate(idxs):
                j[cases[i][0]] = batch.file(row)
        for idxs, batch in PR.decode_pcm_family(fam, p_assets, device="cpu"):
            assert batch.data.device.type == "cpu"
            for row, i in enumerate(idxs):
                p[cases[i][0]] = batch.file(row)
        for n, _ in cases:
            out[(fam, n)] = (j[n], p[n])
    return out


@pytest.mark.parametrize("fam,name", IDS, ids=[f"{f}-{n}" for f, n in IDS])
def test_decode_pcm_family_matches_jax(family_results, fam, name):
    a, b = family_results[(fam, name)]
    assert (a.err, a.sample_rate, a.num_channels, a.bits_per_sample,
            a.format) == (b.err, b.sample_rate, b.num_channels,
                          b.bits_per_sample, b.format)
    assert a.pcm.shape == b.pcm.shape
    np.testing.assert_array_equal(a.pcm, b.pcm)


@pytest.mark.parametrize("fam", sorted(CASES))
def test_parse_meta_batch_matches_jax(fam):
    """Every meta field of every case, malformed ones included."""
    jmod, pmod = PARSERS[fam]
    bufs, lens = _packed(fam)
    jm = jmod.parse_meta_batch(jnp.asarray(bufs), jnp.asarray(lens))
    pm = pmod.parse_meta_batch(torch.as_tensor(bufs), torch.as_tensor(lens))
    assert set(jm) == set(pm)
    for k in jm:
        assert pm[k].dtype == torch.int32, k
        np.testing.assert_array_equal(np.asarray(jm[k]), pm[k].numpy(),
                                      err_msg=k)


#: expected error codes of the malformed cases (both packages agree on
#: these by test_decode_pcm_family_matches_jax)
MALFORMED = {
    ("aiff", "truncated"): E.ERR_EOF, ("aiff", "bad_magic"): E.ERR_UNSUPPORTED,
    ("aiff", "no_ssnd"): E.ERR_EOF, ("aiff", "short"): E.ERR_UNSUPPORTED,
    ("aiff", "bad_comm_size"): E.ERR_INVALID,
    ("aiff", "unsupported_comp"): E.ERR_UNSUPPORTED,
    ("aiff", "pcm12"): E.ERR_UNSUPPORTED, ("aiff", "zero_rate"): E.ERR_INVALID,
    ("aiff", "zero_channels"): E.ERR_INVALID,
    ("au", "bad_magic"): E.ERR_UNSUPPORTED, ("au", "short"): E.ERR_UNSUPPORTED,
    ("au", "offset_past_eof"): E.ERR_EOF,
    ("au", "encoding_23"): E.ERR_UNSUPPORTED,
    ("au", "zero_channels"): E.ERR_INVALID,
    ("au", "offset_in_header"): E.ERR_INVALID,
    ("caf", "rate_inf"): E.ERR_INVALID, ("caf", "rate_nan"): E.ERR_INVALID,
    ("caf", "rate_negative"): E.ERR_INVALID, ("caf", "truncated"): E.ERR_EOF,
    ("caf", "bad_magic"): E.ERR_UNSUPPORTED, ("caf", "no_data"): E.ERR_EOF,
    ("caf", "codec_aac"): E.ERR_UNSUPPORTED,
    ("caf", "packed_mismatch"): E.ERR_UNSUPPORTED,
    ("caf", "size_high_word"): E.ERR_EOF,
}


def test_error_codes_and_rates(family_results):
    for key, code in MALFORMED.items():
        assert family_results[key][1].err == code, key
    good = [k for k in IDS if k not in MALFORMED]
    for key in good:
        assert family_results[key][1].err == E.ERR_OK, key
    rate = {k: family_results[k][1].sample_rate for k in good}
    # 11025.5 comes out of the f32 exp2 as 11025.499, in JAX as here
    assert rate[("aiff", "odd_rate_half")] == 11025
    assert rate[("aiff", "odd_rate_frac")] == 44100
    assert rate[("caf", "rate_half_even")] == 22050
    assert rate[("caf", "rate_frac")] == 44101
    assert rate[("caf", "rate_huge")] == 2**31 - 128  # clipped


def test_read_ieee_extended_matches_jax():
    """The IEEE-80 reader on odd rates, zero, inf/NaN and negative values
    and an edge-clamped read, as f32 bits."""
    from audio_decoder_tpu.ops.bytes import read_ieee_extended as j_read

    from .synth import _pack_ieee_extended

    words = [_pack_ieee_extended(r) for r in
             (44100.0, 44100.3, 11025.5, 1e-3, 7.25, -48000.0, 0.0, 1e30,
              3.0e-40, 192000.0)]
    words += [b"\x7f\xff" + bytes(8), b"\xff\xff\x80" + bytes(7),
              b"\x00\x00\x00\x00\x00\x00\x00\x00\x00\x01",
              b"\x43\xff\x80" + bytes(7)]
    buf = np.zeros((len(words), 24), np.uint8)
    for i, w in enumerate(words):
        buf[i, 3:13] = np.frombuffer(w, np.uint8)
    off = np.full(len(words), 3, np.int32)
    off[-1] = 20  # clamped to the row's last 10 bytes
    import jax

    ref = np.asarray(jax.vmap(j_read)(jnp.asarray(buf), jnp.asarray(off)))
    got = PB.read_ieee_extended(torch.as_tensor(buf), torch.as_tensor(off))
    np.testing.assert_array_equal(ref, got.numpy())  # NaN where JAX has NaN


EDGE_OFFSETS = np.array([0, 5, -3, -100, -5000, 95, 99, 130, 2**31 - 1,
                         -2**31], np.int32)


@pytest.mark.parametrize("reader", ["read_tag", "read_u32le", "read_u16le",
                                    "read_u16be", "read_ieee_extended"])
def test_byte_readers_match_jax_at_the_edges(reader):
    """Reads at, near and past both ends of a row (a negative offset
    counts from the row's end, then the window is clamped into it)."""
    import jax

    from audio_decoder_tpu.ops import bytes as JB

    rng = np.random.default_rng(0xED)
    bufs = rng.integers(0, 256, size=(len(EDGE_OFFSETS), 100), dtype=np.uint8)
    ref = np.asarray(jax.vmap(getattr(JB, reader))(jnp.asarray(bufs),
                                                   jnp.asarray(EDGE_OFFSETS)))
    got = getattr(PB, reader)(torch.as_tensor(bufs),
                              torch.as_tensor(EDGE_OFFSETS)).numpy()
    if reader != "read_ieee_extended":
        ref = ref.astype(np.int64)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("bits", [8, 16, 24])
def test_unpack_pcm_region_edges_match_jax(bits):
    """Sample regions starting at, near and past both ends of the row."""
    from audio_decoder_tpu.ops.unpack import unpack_pcm as j_unpack

    from audio_decoder_tpu_torch.ops.unpack import unpack_pcm as p_unpack

    rng = np.random.default_rng(bits)
    bufs = rng.integers(0, 256, size=(len(EDGE_OFFSETS), 100), dtype=np.uint8)
    nf = np.full(len(EDGE_OFFSETS), 12, np.int32)
    kw = dict(bits=bits, channels=2, big_endian=True, max_frames=16)
    ref = j_unpack(jnp.asarray(bufs), jnp.asarray(EDGE_OFFSETS),
                   jnp.asarray(nf), **kw)
    got = p_unpack(torch.as_tensor(bufs), torch.as_tensor(EDGE_OFFSETS),
                   torch.as_tensor(nf), **kw)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("bits,channels", [(8, 1), (16, 2), (24, 2), (32, 1)])
def test_decode_pcm_step_aiff_matches_jax(bits, channels):
    rng = np.random.default_rng(bits * 10 + channels + 1)
    blobs = [
        make_aiff(_ints(rng, 64, channels, bits), 44100, bits),
        make_aiff(_ints(rng, 17, channels, bits), 22050, bits),
        make_aiff(_ints(rng, 20, 3 - channels, bits), 44100, bits),  # geometry
        make_aiff(_ints(rng, 20, channels, 16), 44100, 16,
                  compression=b"sowt"),                               # format
        make_aiff(_ints(rng, 20, channels, 16 if bits != 16 else 24), 44100,
                  16 if bits != 16 else 24),                          # geometry
        b"FORM\x00\x00",                                              # garbage
    ]
    bufs = np.zeros((len(blobs), 1024), np.uint8)
    lens = np.zeros((len(blobs),), np.int32)
    for i, b in enumerate(blobs):
        bufs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    kw = dict(bits=bits, channels=channels, max_frames=128, family="aiff")
    j_pcm, j_meta = j_step(jnp.asarray(bufs), jnp.asarray(lens), **kw)
    p_pcm, p_meta = p_step(torch.as_tensor(bufs), torch.as_tensor(lens), **kw)
    np.testing.assert_array_equal(np.asarray(j_pcm), p_pcm.numpy())
    assert set(j_meta) == set(p_meta)
    for k in j_meta:
        np.testing.assert_array_equal(np.asarray(j_meta[k]), p_meta[k].numpy(),
                                      err_msg=k)
    assert p_meta["err"][0] == 0 and p_meta["err"][1] == 0
    assert all(p_meta["err"][2:] != 0)


def test_decode_pcm_step_rejects_unknown_family():
    bufs = torch.zeros((1, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="family"):
        p_step(bufs, torch.zeros(1, dtype=torch.int32), max_frames=8,
               family="caf")
