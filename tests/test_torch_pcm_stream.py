"""PyTorch port, ``codecs/pcm_stream.PcmStream`` against the JAX package.

The host header walks are verbatim copies: their dicts (or error classes)
equal JAX's on every WAV/AIFF/AU/CAF case of the port's family tests, and
the port's device parse wherever JAX's own device parse agrees with its
host walk.  The chunks of every kind (PCM at every width, float, G.711,
IMA, MS and ima4 ADPCM) concatenate to the port's one-shot decode bit for
bit at every chunk size and seek tested, chunk for chunk in the JAX
stream's shapes, from bytes and from a memory-mapped path.
"""

import functools

import numpy as np
import pytest
import torch

import audio_decoder_tpu as J
import audio_decoder_tpu_torch as P
from audio_decoder_tpu.codecs import aiff as JAIFF
from audio_decoder_tpu.codecs import au as JAU
from audio_decoder_tpu.codecs import caf as JCAF
from audio_decoder_tpu.codecs import pcm_stream as JPS
from audio_decoder_tpu.codecs import wav as JWAV
from audio_decoder_tpu_torch.codecs import aiff as PAIFF
from audio_decoder_tpu_torch.codecs import au as PAU
from audio_decoder_tpu_torch.codecs import caf as PCAF
from audio_decoder_tpu_torch.codecs import pcm_stream as PPS
from audio_decoder_tpu_torch.codecs import wav as PWAV
from audio_decoder_tpu_torch.io.assets import Asset as PAsset
from audio_decoder_tpu_torch.io.assets import pack_bytes

from . import ima_ref as IR
from . import ms_ref as MR
from .seeded_writers import ima_wav, ms_wav
from .synth import make_aiff, make_au, make_caf, make_wav
from .test_torch_pcm_families import CASES as FAMILY_CASES
from .test_torch_wav import CASES as WAV_CASES


CPU = "cpu"


def _cat(chunks, ch: int) -> np.ndarray:
    chunks = list(chunks)
    for c in chunks:
        assert c.dtype == np.float32 and c.ndim == 2 and c.shape[1] == ch
    return (np.concatenate(chunks) if chunks
            else np.zeros((0, ch), np.float32))


@functools.lru_cache(maxsize=None)
def _oneshot(blob: bytes, ext: str) -> np.ndarray:
    """The port's one-shot decode of one file on the CPU."""
    b = P.decode_assets([PAsset(path=f"x.{ext}", name="x", ext=ext,
                                data=blob)], device=CPU)
    f = b.file(0)
    assert f.err == 0
    return f.pcm[:, : f.num_channels]


def _jax_then_port(jfn, pfn):
    """Both calls' exception classes (by name) and codes."""
    out = []
    for fn in (jfn, pfn):
        with pytest.raises(Exception) as ei:
            fn()
        out.append((type(ei.value).__name__, getattr(ei.value, "code", None)))
    return out


# ---------------------------------------------------------------------------
# PcmStream: the header walks
# ---------------------------------------------------------------------------

HEADERS = {  # family: (JAX host walk, port host walk, JAX device, port device)
    "wav": (JPS.parse_wav_header, PPS.parse_wav_header,
            JWAV.parse_meta_batch, PWAV.parse_meta_batch),
    "aiff": (JPS.parse_aiff_header, PPS.parse_aiff_header,
             JAIFF.parse_meta_batch, PAIFF.parse_meta_batch),
    "au": (JPS.parse_au_header, PPS.parse_au_header, JAU.parse_meta_batch,
           PAU.parse_meta_batch),
    "caf": (JPS.parse_caf_header, PPS.parse_caf_header,
            JCAF.parse_meta_batch, PCAF.parse_meta_batch),
}
HEADER_CASES = {"wav": WAV_CASES, **FAMILY_CASES}


def _host(fn, blob):
    try:
        return fn(np.frombuffer(blob, np.uint8))
    except Exception as e:  # the class and code are what is compared
        return (type(e).__name__, getattr(e, "code", None))


@pytest.mark.parametrize("fam", sorted(HEADERS))
def test_header_walks_match_jax_and_the_device_parse(fam):
    import jax.numpy as jnp

    jhost, phost, jdev, pdev = HEADERS[fam]
    cases = HEADER_CASES[fam]
    bufs, lens = pack_bytes([b for _, b in cases])
    jm = {k: np.asarray(v) for k, v in
          jdev(jnp.asarray(bufs), jnp.asarray(lens)).items()}
    pm = {k: v.numpy() for k, v in
          pdev(torch.as_tensor(bufs), torch.as_tensor(lens)).items()}
    agree = 0
    for i, (name, blob) in enumerate(cases):
        a, b = _host(jhost, blob), _host(phost, blob)
        assert a == b, name
        if isinstance(a, dict):
            jd = {k: int(jm[k][i]) for k in a}
            pd = {k: int(pm[k][i]) for k in a}
            if jd == a and jm["err"][i] == 0:  # JAX's host and device agree
                assert pd == b and pm["err"][i] == 0, name
                agree += 1
        elif a[1] == jm["err"][i]:
            assert pm["err"][i] == b[1], name
            agree += 1
    assert agree >= len(cases) - 2


# ---------------------------------------------------------------------------
# PcmStream: chunks
# ---------------------------------------------------------------------------


def _tone(rng, frames, ch):
    t = np.arange(frames)[:, None]
    x = 9000 * np.sin(2 * np.pi * 440 * t / 44100 + np.arange(ch))
    return np.clip(x + rng.normal(0, 1500, (frames, ch)), -32768,
                   32767).astype(np.int16)


def _ints(rng, frames, ch, bits):
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(frames, ch))


def _pcm_blobs():
    rng = np.random.default_rng(0x5772)
    fl = np.clip(rng.standard_normal((2345, 2)) * 0.4, -1, 1)
    g711 = rng.integers(0, 256, 3000).astype(np.uint8).tobytes()
    z1, z2 = np.zeros((0, 1), np.int64), np.zeros((0, 2), np.int64)
    tone = _tone(rng, 3001, 2)
    return {  # name: (bytes, extension)
        "wav8": (make_wav(_ints(rng, 2001, 1, 8), 8000, 8), "wav"),
        "wav16": (make_wav(_ints(rng, 2345, 2, 16), 44100, 16), "wav"),
        "wav24": (make_wav(_ints(rng, 1999, 2, 24), 48000, 24), "wav"),
        "wav32": (make_wav(_ints(rng, 1500, 1, 32), 96000, 32), "wav"),
        "wav_f32": (make_wav(fl.astype(np.float32), 44100, 32, float32=True),
                    "wav"),
        "wav_f64": (make_wav(fl[:1000], 44100, 64, float64=True), "wav"),
        "wav_ulaw": (make_wav(z1, 8000, 8, data_override=g711,
                              fmt_code_override=7), "wav"),
        "aiff16": (make_aiff(_ints(rng, 2100, 2, 16), 44100, 16), "aif"),
        "aiff24": (make_aiff(_ints(rng, 1800, 1, 24), 48000, 24,
                             ssnd_offset=12), "aif"),
        "aifc_sowt": (make_aiff(_ints(rng, 2222, 2, 16), 44100, 16,
                                compression=b"sowt"), "aifc"),
        "aifc_alaw": (make_aiff(z2, 8000, 16, compression=b"alaw",
                                data_override=g711, frames_override=1500),
                      "aifc"),
        "au16": (make_au(_ints(rng, 2050, 2, 16), 44100, 3), "au"),
        "au_ulaw": (make_au(z1, 8000, 1, data_override=g711), "au"),
        "caf16": (make_caf(_ints(rng, 1900, 2, 16), 44100, bits=16), "caf"),
        "caf_f32le": (make_caf(fl.astype(np.float32), 32000, bits=32,
                               little=True, float_=True), "caf"),
        "ima": (ima_wav(IR.encode(tone, 256), 2, 256), "wav"),
        "ima_fact": (ima_wav(IR.encode(tone[:, :1], 512), 1, 512,
                             fact=2900), "wav"),
        "ms": (ms_wav(MR.encode(tone, 256), 2, 256), "wav"),
        "ima4_aifc": (make_aiff(z2, 22050, 16, compression=b"ima4",
                                data_override=IR.encode_ima4(tone),
                                frames_override=3001 // 64 * 64), "aifc"),
        "ima4_caf": (make_caf(z1, 22050, codec=b"ima4",
                              data_override=IR.encode_ima4(tone[:, :1])),
                     "caf"),
    }


PCM = _pcm_blobs()
ADPCM = ("ima", "ima_fact", "ms", "ima4_aifc", "ima4_caf")


@pytest.fixture(scope="module")
def jax_pcm_oneshot():
    """The JAX package's one-shot decode of every PcmStream case."""
    from audio_decoder_tpu.io.assets import Asset as JAsset

    names = sorted(PCM)
    batch = J.decode_assets([JAsset(path=f"{n}.{PCM[n][1]}", name=n,
                                    ext=PCM[n][1], data=PCM[n][0])
                             for n in names])
    out = {}
    for i, n in enumerate(names):
        f = batch.file(i)
        assert f.err == 0, n
        out[n] = np.asarray(f.pcm[:, : f.num_channels])
    return out


@pytest.mark.parametrize("fpc", [1, 100, 1 << 17])
@pytest.mark.parametrize("name", sorted(PCM))
def test_pcm_stream_equals_oneshot_and_jax(jax_pcm_oneshot, name, fpc):
    blob, ext = PCM[name]
    whole = _oneshot(blob, ext)
    assert np.array_equal(whole, jax_pcm_oneshot[name])
    if fpc == 1 and name not in ADPCM:
        fpc = 3  # one frame a chunk is thousands of calls: 3 still splits
    st = PPS.PcmStream(blob, frames_per_chunk=fpc, device=CPU)
    js = JPS.PcmStream(blob, frames_per_chunk=fpc)
    assert st.container == js.container
    assert (st.total_samples, st.channels, st.sample_rate, st.bits) == (
        js.total_samples, js.channels, js.sample_rate, js.bits)
    got = list(st)
    ref = list(js)
    assert [c.shape for c in got] == [c.shape for c in ref]
    assert np.array_equal(_cat(got, st.channels), whole)
    assert np.array_equal(np.concatenate(ref), whole)


@pytest.mark.parametrize("name", sorted(PCM))
def test_pcm_stream_seek(name):
    blob, ext = PCM[name]
    whole = _oneshot(blob, ext)
    st = PPS.PcmStream(blob, frames_per_chunk=200, device=CPU)
    n = st.total_samples
    q = getattr(st, "_spb", 1)  # the seek quantum
    for s in sorted({0, 1, q - 1, q, q + 1, 2 * q + 7, 333, n - 1, n}):
        if not 0 <= s <= n:
            continue
        got = _cat(st.chunks(start_sample=s), st.channels)
        assert np.array_equal(got, whole[s:]), f"seek {s}"
    with pytest.raises(ValueError):
        next(st.chunks(start_sample=n + 1))


class _no_warnings:
    """Fail on any warning (a non-writable map handed to torch warns)."""

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


@pytest.mark.parametrize("name", sorted(PCM))
def test_pcm_stream_from_a_mapped_path(tmp_path, name):
    blob, ext = PCM[name]
    path = tmp_path / f"{name}.{ext}"
    path.write_bytes(blob)
    with _no_warnings():
        st = PPS.PcmStream(str(path), frames_per_chunk=500, device=CPU)
        assert isinstance(st._mm, np.memmap)
        got = _cat(st.chunks(start_sample=17), st.channels)
    assert np.array_equal(got, _oneshot(blob, ext)[17:])


@pytest.mark.parametrize("case", ["missing-path", "fpc0", "container",
                                  "zeros", "truncated"])
def test_pcm_stream_errors_match_jax(tmp_path, case):
    blob = PCM["wav16"][0]
    src, kw = {
        "missing-path": (str(tmp_path / "missing.wav"), {}),
        "fpc0": (blob, dict(frames_per_chunk=0)),
        "container": (blob, dict(container="ogg")),
        "zeros": (b"\x00" * 64, {}),
        "truncated": (blob[:40], {}),
    }[case]
    j, p = _jax_then_port(lambda: JPS.PcmStream(src, **kw),
                          lambda: PPS.PcmStream(src, device=CPU, **kw))
    assert j == p
