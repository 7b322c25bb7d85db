"""PyTorch port, the streaming decoders against the JAX package: the MPEG
streams (``Mp3Stream``, ``L12Stream``, ``mpeg_stream``), ``gapless_bounds``
and ``io/stream.py`` (``stream_file`` for every extension,
``stream_decode``, ``decode_all``).  ``PcmStream`` has its own file,
tests/test_torch_pcm_stream.py.

Every stream must concatenate to the port's own one-shot decode on the
same device bit for bit, at every chunk size and seek tested.  Against
the JAX package on the same numpy-seeded bytes: PCM, ADPCM and FLAC
streams are exact, MPEG streams within amplitude-scaled RMS 5e-7 (the
repo's float32 round-off bar, ``tests/test_mp3_tpu.py``).  On the CPU
every kernel runs its plain twin.
"""

import inspect
import itertools
import os
import struct

import numpy as np
import pytest
import torch

import audio_decoder_tpu as J
import audio_decoder_tpu_torch as P
from audio_decoder_tpu.codecs.mpeg import decoder as JMD
from audio_decoder_tpu.io import stream as JIS
from audio_decoder_tpu_torch.codecs import pcm_stream as PPS
from audio_decoder_tpu_torch.codecs.flac.stream import FlacStream
from audio_decoder_tpu_torch.codecs.mpeg import decoder as PMD
from audio_decoder_tpu_torch.io import stream as PIS
from audio_decoder_tpu_torch.io.assets import Asset as PAsset

from . import codec_refs as CR
from . import flac_writer as FW
from .seeded_writers import layer1_frames, layer2_frames
from .test_torch_pcm_stream import CPU, PCM, _cat, _jax_then_port, _oneshot

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
MP3 = {"stereo": os.path.join(DATA, "stereo_44k1_128k_js.mp3"),
       "lsf": os.path.join(DATA, "mono_22k05_lsf.mp3")}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _scaled_rms(ref, got):
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    return rms, 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)


# ---------------------------------------------------------------------------
# Layer III: Mp3Stream
# ---------------------------------------------------------------------------


#: chunks of the stereo fixture decoded at granules_per_chunk 8 (all 96 of
#: them take about 30 s of plain-twin time on the CPU): the first 40, and
#: every chunk from the last 40 on
GPC8_HEAD = 40


@pytest.mark.parametrize("gpc", [8, 64, 512])
@pytest.mark.parametrize("fixture", sorted(MP3))
def test_mp3_stream_equals_oneshot(fixture, gpc):
    blob = _read(MP3[fixture])
    whole = _oneshot(blob, "mp3")
    st = PMD.Mp3Stream(blob, granules_per_chunk=gpc, device=CPU)
    assert st.device.type == "cpu"
    assert (st.total_samples, st.channels) == whole.shape
    n_chunks = -(-st.n_granules // gpc)
    if fixture == "stereo" and gpc == 8:
        head = _cat(itertools.islice(st.chunks(), GPC8_HEAD), st.channels)
        assert np.array_equal(head, whole[: len(head)])
        s = (n_chunks - GPC8_HEAD) * gpc * 576
        tail = _cat(st.chunks(start_sample=s), st.channels)
        assert np.array_equal(tail, whole[s:])
        return
    chunks = list(st)
    assert len(chunks) == n_chunks
    got = _cat(chunks, st.channels)
    assert np.array_equal(got, whole), f"max diff {np.abs(got - whole).max()}"


@pytest.mark.parametrize("fixture", sorted(MP3))
def test_mp3_stream_matches_jax(fixture):
    blob = _read(MP3[fixture])
    js = JMD.Mp3Stream(blob, granules_per_chunk=512)
    ps = PMD.Mp3Stream(blob, granules_per_chunk=512, device=CPU)
    for k in ("channels", "sample_rate", "n_granules", "total_samples",
              "_n_big", "_buckets"):
        assert getattr(js, k) == getattr(ps, k), k
    # the port sizes main_data over every window a seek can start, JAX's
    # over the windows of an unseeked run only
    assert ps._m_cap >= js._m_cap
    ref = np.concatenate(list(js))
    got = _cat(ps, ps.channels)
    assert got.shape == ref.shape
    rms, bar = _scaled_rms(ref, got)
    assert rms < bar, f"rms {rms:.3e} >= bar {bar:.3e}"


@pytest.mark.parametrize("fixture", sorted(MP3))
def test_mp3_stream_seek(fixture):
    blob = _read(MP3[fixture])
    whole = _oneshot(blob, "mp3")
    st = PMD.Mp3Stream(blob, granules_per_chunk=512, device=CPU)
    n = st.total_samples
    for s in (0, 1, 575, 576, 577, n // 2 + 123, n - 1, n):
        # a seek far from the end is held on its first two chunks
        got = _cat(itertools.islice(st.chunks(start_sample=s), 2),
                   st.channels)
        assert np.array_equal(got, whole[s: s + len(got)]), f"seek {s}"
        assert len(got) == min(n, (s // 576 + 1024) * 576) - s
    for s in (-1, n + 1):
        with pytest.raises(ValueError):
            next(st.chunks(start_sample=s))


def _windows(st):
    """Every chunk window [lo, hi) of ``st`` a seek can give."""
    g = st.n_granules
    return [(max(a - st.WARMUP, 0), min(a + st.gpc, g)) for a in range(g)]


@pytest.mark.parametrize("gpc", [8, 64, 512])
@pytest.mark.parametrize("fixture", sorted(MP3))
def test_mp3_stream_byte_cap_covers_every_seek_window(fixture, gpc):
    """The stream's main_data slice holds the bytes of any chunk, from any
    seek: ``_widest_window`` equals the largest byte window by brute
    force."""
    st = PMD.Mp3Stream(_read(MP3[fixture]), granules_per_chunk=gpc,
                       device=CPU)
    widest = max(st._byte_window(lo, hi)[1] for lo, hi in _windows(st))
    assert st._widest_window(st.gpc + st.WARMUP) == widest
    assert widest <= st._m_cap == PMD._bucket(widest, 1024)


def test_mp3_stream_seek_into_the_widest_window():
    """A seek whose first chunk spans more main_data bytes than any chunk
    of an unseeked run (the stereo fixture at granules_per_chunk 512)
    decodes exactly."""
    blob = _read(MP3["stereo"])
    st = PMD.Mp3Stream(blob, granules_per_chunk=512, device=CPU)
    ws = _windows(st)
    sizes = [st._byte_window(lo, hi)[1] for lo, hi in ws]
    a = int(np.argmax(sizes))
    unseeked = max(sizes[0::st.gpc])
    assert sizes[a] > unseeked
    s = a * 576 + 100
    got = _cat(itertools.islice(st.chunks(start_sample=s), 1), st.channels)
    assert np.array_equal(got, _oneshot(blob, "mp3")[s: s + len(got)])


def test_mp3_stream_chunk_wire_raises_past_the_byte_cap():
    st = PMD.Mp3Stream(_read(MP3["lsf"]), granules_per_chunk=64, device=CPU)
    lo, hi = 0, 64
    st._m_cap = st._byte_window(lo, hi)[1] - 1
    with pytest.raises(ValueError, match="main_data bytes"):
        st.chunk_wire(lo, hi)


@pytest.mark.parametrize("n", [1, 2111, 65536, 65537, 140000])
def test_imdct_product_rows_do_not_depend_on_the_row_count(n):
    """The Layer III IMDCT product runs in calls of a fixed row count, so
    a row's result is the same in a stream's chunk as in the whole file."""
    from audio_decoder_tpu_torch.codecs.mpeg import dsp

    g = torch.Generator().manual_seed(n)
    a = torch.randn((140000, 18), generator=g)
    w = dsp._consts(torch.device(CPU))["w_all"][1].t()
    whole = dsp._fixed_rows_mm(a, w)
    got = dsp._fixed_rows_mm(a[:n].reshape(1, n, 18), w)
    assert got.shape == (1, n, 36)
    assert torch.equal(got[0], whole[:n])
    torch.testing.assert_close(whole, a @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("calls,extra", [(1, -1), (1, 0), (1, 1), (2, 5)])
def test_imdct_product_rows_do_not_depend_on_the_call_boundaries(calls,
                                                                 extra):
    """Row counts around whole calls of ``_MM_ROWS`` rows: each row equals
    the same row of a longer product."""
    from audio_decoder_tpu_torch.codecs.mpeg import dsp

    R = dsp._MM_ROWS
    n = calls * R + extra
    g = torch.Generator().manual_seed(n)
    a = torch.randn((2 * R + 5, 18), generator=g)
    w = dsp._consts(torch.device(CPU))["w_all"][3].t()
    assert torch.equal(dsp._fixed_rows_mm(a[:n], w),
                       dsp._fixed_rows_mm(a, w)[:n])


def _l2_blob(n_frames: int = 12) -> bytes:
    return layer2_frames(np.random.default_rng(3), n_frames, 2, sr=44100,
                         kbps=192)


@pytest.mark.parametrize("case", ["layer2", "garbage", "gpc7",
                                  "garbage-mpeg_stream"])
def test_mp3_stream_errors_match_jax(case):
    blob = {"layer2": _l2_blob(), "gpc7": _read(MP3["stereo"])}.get(
        case, b"\x00" * 4096)
    if case == "garbage-mpeg_stream":
        j, p = _jax_then_port(lambda: JMD.mpeg_stream(blob),
                              lambda: PMD.mpeg_stream(blob, device=CPU))
    else:
        gpc = 7 if case == "gpc7" else 512
        j, p = _jax_then_port(
            lambda: JMD.Mp3Stream(blob, granules_per_chunk=gpc),
            lambda: PMD.Mp3Stream(blob, granules_per_chunk=gpc, device=CPU))
    assert j == p
    want = {"layer2": "UnsupportedFormatError", "gpc7": "ValueError"}
    if case in want:
        assert p[0] == want[case]


# ---------------------------------------------------------------------------
# Layers I/II: L12Stream, and mpeg_stream's routing
# ---------------------------------------------------------------------------

L12 = {
    "layer1": (lambda: layer1_frames(np.random.default_rng(21), 40, 2), "mp1"),
    "layer2": (lambda: layer2_frames(np.random.default_rng(22), 30, 2,
                                     sr=48000, kbps=256, joint_ext=1), "mp2"),
    "layer2_mono": (lambda: layer2_frames(np.random.default_rng(23), 20, 1,
                                          sr=44100, kbps=96), "mp2"),
}


@pytest.mark.parametrize("fpc", [2, 128])
@pytest.mark.parametrize("name", sorted(L12))
def test_l12_stream_equals_oneshot(name, fpc):
    make, ext = L12[name]
    blob = make()
    whole = _oneshot(blob, ext)
    st = PMD.L12Stream(blob, frames_per_chunk=fpc, device=CPU)
    assert st.layer == (1 if ext == "mp1" else 2)
    assert st.WARMUP == (2 if ext == "mp1" else 1)
    assert (st.total_samples, st.channels) == whole.shape
    chunks = list(st)
    assert len(chunks) == -(-st.n_frames // fpc)
    assert np.array_equal(_cat(chunks, st.channels), whole)


@pytest.mark.parametrize("name", sorted(L12))
def test_l12_stream_matches_jax_and_seeks(name):
    make, ext = L12[name]
    blob = make()
    whole = _oneshot(blob, ext)
    js = JMD.L12Stream(blob, frames_per_chunk=8)
    ps = PMD.L12Stream(blob, frames_per_chunk=8, device=CPU)
    for k in ("layer", "channels", "sample_rate", "n_frames",
              "total_samples", "WARMUP"):
        assert getattr(js, k) == getattr(ps, k), k
    ref = np.concatenate(list(js))
    got = _cat(ps, ps.channels)
    rms, bar = _scaled_rms(ref, got)
    assert got.shape == ref.shape and rms < bar, (rms, bar)
    spf = ps.spf * 32
    n = ps.total_samples
    for s in (1, spf - 1, spf, spf + 1, 8 * spf + 5, n - 1, n):
        got = _cat(ps.chunks(start_sample=s), ps.channels)
        assert np.array_equal(got, whole[s:]), f"seek {s}"
    with pytest.raises(ValueError):
        next(ps.chunks(start_sample=n + 1))


@pytest.mark.parametrize("case", ["fpc1", "layer3-as-l12", "no-frames"])
def test_l12_stream_errors_match_jax(case):
    blob = {"layer3-as-l12": _read(MP3["lsf"]),
            "no-frames": b"\x00" * 2048}.get(case, L12["layer1"][0]())
    kw = dict(frames_per_chunk=1) if case == "fpc1" else {}
    layer = 1 if case == "no-frames" else None
    j, p = _jax_then_port(lambda: JMD.L12Stream(blob, layer, **kw),
                          lambda: PMD.L12Stream(blob, layer, device=CPU, **kw))
    assert j == p


@pytest.mark.parametrize("name,cls,layer", [
    ("stereo", PMD.Mp3Stream, 3), ("lsf", PMD.Mp3Stream, 3),
    ("layer1", PMD.L12Stream, 1), ("layer2", PMD.L12Stream, 2),
])
def test_mpeg_stream_routes_by_layer(name, cls, layer):
    blob = _read(MP3[name]) if name in MP3 else L12[name][0]()
    st = PMD.mpeg_stream(blob, granules_per_chunk=64, frames_per_chunk=4,
                         device=CPU)
    jst = JMD.mpeg_stream(blob, granules_per_chunk=64, frames_per_chunk=4)
    assert type(st) is cls and type(jst).__name__ == cls.__name__
    if layer == 3:
        assert st.gpc == 64
    else:
        assert st.layer == layer and st.fpc == 4


# ---------------------------------------------------------------------------
# gapless_bounds
# ---------------------------------------------------------------------------


def _info_frame(template: bytes, *, frames: int | None, delay: int,
                padding: int) -> bytes:
    """A Xing "Info" frame with a LAME extension, built on the first
    frame header of ``template`` (written here with numpy and struct)."""
    from audio_decoder_tpu_torch.codecs.mpeg import frontend as FR

    pos, h = FR.find_frames(template)[0]
    frame = np.zeros(h["frame_len"], np.uint8)
    frame[:4] = np.frombuffer(template[pos:pos + 4], np.uint8)
    xo = FR._xing_offset(0, h)
    tag = b"Info" + struct.pack(">I", 1 if frames is not None else 0)
    if frames is not None:
        tag += struct.pack(">I", frames)
    lame = bytearray(b"LAME3.100" + bytes(27))
    lame[21] = delay >> 4
    lame[22] = ((delay & 15) << 4) | (padding >> 8)
    lame[23] = padding & 255
    tag += bytes(lame)
    frame[xo:xo + len(tag)] = np.frombuffer(tag, np.uint8)
    return frame.tobytes()


def _gapless_cases():
    stereo, lsf = _read(MP3["stereo"]), _read(MP3["lsf"])
    cases = [("untagged-stereo", stereo, None), ("untagged-lsf", lsf, None)]
    for name, base in (("stereo", stereo), ("lsf", lsf)):
        n = len(_oneshot(base, "mp3"))
        for frames in (None, n // (1152 if name == "stereo" else 576) - 2):
            blob = _info_frame(base, frames=frames, delay=576,
                               padding=1201) + base
            cases.append((f"tagged-{name}-frames{frames}", blob, n))
        tiny = _info_frame(base, frames=3, delay=4000, padding=9) + base
        cases.append((f"tagged-{name}-past-the-end", tiny, 1000))
    return cases


GAPLESS = _gapless_cases()


@pytest.mark.parametrize("name,blob,total", GAPLESS,
                         ids=[c[0] for c in GAPLESS])
def test_gapless_bounds_matches_jax(name, blob, total):
    total = total if total is not None else len(_oneshot(blob, "mp3"))
    got = PMD.gapless_bounds(blob, total)
    assert got == JMD.gapless_bounds(blob, total)
    assert PMD.DECODER_DELAY == JMD.DECODER_DELAY == 529
    if name.startswith("untagged") or name.endswith("past-the-end"):
        assert got is None
    else:
        assert got is not None and got[0] == 576 + 529


def test_gapless_bounds_on_a_lame_stream():
    if not CR.have_lame():
        pytest.skip("system lame not available")
    rng = np.random.default_rng(17)
    n = int(44100 * 0.7) + 313
    s = 0.4 * np.sin(2 * np.pi * 441 * np.arange(n) / 44100)
    pcm = (np.stack([s + 0.05 * rng.standard_normal(n)] * 2, 1)
           * 30000).clip(-32768, 32767).astype(np.int16)
    blob = CR.lame_encode(pcm, 44100, 128, mode=1, write_vbr_tag=True)
    total = len(_oneshot(blob, "mp3"))
    got = PMD.gapless_bounds(blob, total)
    assert got is not None and got == JMD.gapless_bounds(blob, total)
    assert got[1] == n


# ---------------------------------------------------------------------------
# io/stream.py: stream_file, stream_decode, decode_all
# ---------------------------------------------------------------------------

def _flac_blob() -> bytes:
    """A 12,000-frame stereo 16-bit FLAC (24 mid/side frames of 512)."""
    rng = np.random.default_rng(0xF1AC)
    x = np.cumsum(rng.integers(-300, 301, size=(12000, 2)), axis=0)
    return FW.encode_file(np.clip(x, -32768, 32767), 44100, 16,
                          blocksize=512, stereo="mid_side")


FILES = {  # extension: bytes
    "wav": PCM["wav16"][0], "aif": PCM["aiff16"][0],
    "aifc": PCM["ima4_aifc"][0], "au": PCM["au16"][0],
    "caf": PCM["caf_f32le"][0], "mp3": _read(MP3["lsf"]),
    "mp2": L12["layer2"][0](), "mp1": L12["layer1"][0](),
    "flac": _flac_blob(),
}


@pytest.mark.parametrize("ext", sorted(FILES))
def test_stream_file_every_extension(tmp_path, ext):
    path = tmp_path / f"x.{ext}"
    path.write_bytes(FILES[ext])
    whole = _oneshot(FILES[ext], ext)
    kw = dict(granules_per_chunk=64, frames_per_chunk=8,
              pcm_frames_per_chunk=700, flac_frames_per_chunk=5)
    got = _cat(P.stream_file(str(path), device=CPU, **kw), whole.shape[1])
    assert np.array_equal(got, whole)
    s = 1234
    got = _cat(PIS.stream_file(str(path), start_sample=s, device=CPU, **kw),
               whole.shape[1])
    assert np.array_equal(got, whole[s:])
    ref = np.concatenate(list(JIS.stream_file(str(path), start_sample=s,
                                              **kw)))
    if ext in ("mp3", "mp2", "mp1"):
        rms, bar = _scaled_rms(ref, got)
        assert ref.shape == got.shape and rms < bar
    else:
        assert np.array_equal(got, ref)


def test_flac_stream_through_stream_file_matches_flacstream(tmp_path):
    path = tmp_path / "x.flac"
    path.write_bytes(FILES["flac"])
    a = list(P.stream_file(str(path), device=CPU, flac_frames_per_chunk=7))
    b = list(FlacStream(FILES["flac"], frames_per_chunk=7,
                        device=CPU).chunks())
    assert len(a) == len(b) > 1
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _folder(tmp_path):
    paths = []
    for i, ext in enumerate(("wav", "mp3", "aif", "flac", "au", "mp2", "caf")):
        p = tmp_path / f"f{i}.{ext}"
        p.write_bytes(FILES[ext])
        paths.append(str(p))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"\x00" * 64)
    return paths + [str(bad)]


def _same_batch(a, b):
    assert a.names == b.names and a.formats == b.formats
    assert a.channels == b.channels and a.data.shape == b.data.shape
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.data, b.data)


def test_stream_decode_yields_chunks_in_order(tmp_path):
    paths = _folder(tmp_path)
    got = list(P.stream_decode(paths, files_per_batch=3, prefetch=1,
                               device=CPU))
    assert [c for c, _ in got] == [paths[i:i + 3] for i in range(0, 8, 3)]
    jgot = list(J.stream_decode(paths, files_per_batch=3, prefetch=1))
    for (chunk, batch), (_jc, jb) in zip(got, jgot):
        assert batch.data.device.type == "cpu"
        _same_batch(batch, P.decode_paths(chunk, device=CPU))
        assert batch.names == jb.names
        assert batch.err.tolist() == np.asarray(jb.err).tolist()
        assert batch.valid_frames.tolist() == np.asarray(
            jb.valid_frames).tolist()


def test_stream_decode_reraises_an_unreadable_path(tmp_path):
    paths = _folder(tmp_path)
    paths.insert(4, str(tmp_path / "missing.wav"))
    errs = []
    for stream in (P.stream_decode(paths, files_per_batch=2, device=CPU),
                   J.stream_decode(paths, files_per_batch=2)):
        seen = []
        with pytest.raises(OSError) as ei:
            for chunk, _ in stream:
                seen.append(chunk)
        errs.append((type(ei.value), seen))
    assert errs[0] == errs[1]
    assert errs[0][1] == [paths[0:2], paths[2:4]]


def test_stream_decode_stops_its_reader_when_closed(tmp_path):
    import threading

    paths = _folder(tmp_path) * 3
    before = threading.active_count()
    it = P.stream_decode(paths, files_per_batch=1, prefetch=1, device=CPU)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_decode_all_equals_decode_paths(tmp_path):
    paths = _folder(tmp_path)
    _same_batch(PIS.decode_all(paths, files_per_batch=3, device=CPU),
                P.decode_paths(paths, device=CPU))
    j = JIS.decode_all(paths, files_per_batch=3)
    p = PIS.decode_all(paths, files_per_batch=3, device=CPU)
    assert p.names == j.names and p.err.tolist() == np.asarray(j.err).tolist()


def test_decode_all_of_nothing_is_the_empty_batch():
    p = PIS.decode_all([], device=CPU)
    j = JIS.decode_all([])
    assert tuple(p.data.shape) == tuple(j.data.shape) == (0, 1)
    assert p.data.dtype == torch.float32 and p.data.device.type == "cpu"
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        t = getattr(p, k)
        assert t.dtype == torch.int32 and tuple(t.shape) == (0,)


# ---------------------------------------------------------------------------
# Every entry point defaults to the card
# ---------------------------------------------------------------------------

ENTRY_POINTS = {
    "stream_file": (PIS.stream_file, lambda f: list(f(FILE_ARG))),
    "stream_decode": (PIS.stream_decode, lambda f: list(f([FILE_ARG]))),
    "decode_all": (PIS.decode_all, lambda f: f([FILE_ARG])),
    "Mp3Stream": (PMD.Mp3Stream, lambda f: f(_read(MP3["lsf"]))),
    "L12Stream": (PMD.L12Stream, lambda f: f(L12["layer2"][0]())),
    "mpeg_stream": (PMD.mpeg_stream, lambda f: f(_read(MP3["lsf"]))),
    "PcmStream": (PPS.PcmStream, lambda f: f(PCM["wav16"][0])),
    "consensus_for": (P.consensus_for, lambda f: f(_batch())),
    "resample_batch": (P.resample_batch,
                       lambda f: f(np.zeros((1, 64, 1), np.float32), 1, 2)),
    "resample_to_consensus": (P.resample_to_consensus,
                              lambda f: f(_batch(), 44100)),
    "route_channels": (P.route_channels,
                       lambda f: f(np.zeros((1, 4, 1), np.float32), 2)),
}
FILE_ARG = os.path.join(DATA, "mono_22k05_lsf.mp3")


def _batch():
    return P.decode_paths([FILE_ARG], device=CPU)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(fn)
