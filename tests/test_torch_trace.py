"""The port's spans and counters (``audio_decoder_tpu_torch/utils/trace.py``).

CPU: a span with no profiler opens no ``record_function`` and still adds
its host time; under a profiler ``decode_assets`` of the stereo MP3
fixture opens exactly the MP3 route's ranges, nested under one numbered
``decode.call``; ``to_device`` counts the copies and bytes it was handed;
the profiler flag the span reads follows ``torch.profiler.profile``;
``cli decode --stats`` prints each family's decoded audio-seconds; and the
live loop's counters count a known script exactly, its spans open under a
profiler, every fetch it makes goes through ``to_host``, and the host
values its commands put on the device go through ``to_device``, while
its chance rolls put none.

On the card (marker ``cuda``; ``python -m pytest tests/test_torch_trace.py
-m cuda --noconftest -q``): the ``sync`` counter equals torch's own count
of synchronizing operations on the MP3 and FLAC routes and in the live
loop under commands of every verb, and the MP3 DSP spans and the loop's
``engine.render`` read device time under a profiler and none without one.
"""

import os
import re
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_decoder_tpu_torch import cli
from audio_decoder_tpu_torch.codecs.registry import decode_assets
from audio_decoder_tpu_torch.engine import commands as EC
from audio_decoder_tpu_torch.engine import state as ES
from audio_decoder_tpu_torch.io.assets import load_assets
from audio_decoder_tpu_torch.runtime import loop as loop_mod
from audio_decoder_tpu_torch.runtime.native import Sink
from audio_decoder_tpu_torch.utils import trace

from .synth import make_wav

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_port")
MP3 = os.path.join(DATA, "stereo_44k1_128k_js.mp3")
FLAC = os.path.join(DATA, "music_44k1_s16.flac")

#: the spans of one MP3 Layer III call, beside its numbered decode.call
MP3_ROUTE = {"decode.route", "decode.mp3", "decode.assemble", "mp3.walk", "mp3.wire",
             "mp3.entropy", "mp3.requantize", "mp3.stereo", "mp3.imdct", "mp3.synth"}
#: the spans that record CUDA events on a card
DEVICE_TIMED = ("mp3.entropy", "mp3.requantize", "mp3.stereo", "mp3.imdct", "mp3.synth")


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.TRACE.reset()
    yield
    trace.TRACE.reset()


class _CountingRange:
    """Stands in for record_function and counts its entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


def test_a_span_without_a_profiler_opens_no_range(monkeypatch):
    monkeypatch.setattr(trace, "record_function", _CountingRange)
    _CountingRange.entered = 0
    assert not trace._autograd_profiler._is_profiler_enabled
    for _ in range(3):
        with trace.span("x.y", device="cpu"):
            pass
    assert _CountingRange.entered == 0
    s = trace.TRACE.stats["x.y"]
    assert s.calls == 3 and s.seconds > 0
    assert not trace.TRACE.events and trace.TRACE.device_ms("x.y") is None


def test_a_span_under_a_profiler_opens_its_range(monkeypatch):
    monkeypatch.setattr(trace, "record_function", _CountingRange)
    _CountingRange.entered = 0
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("x.y", device="cpu"):
            pass
    assert _CountingRange.entered == 1 and trace.TRACE.stats["x.y"].calls == 1
    # a CPU device records no events
    assert trace.TRACE.device_ms("x.y") is None


def test_the_profiler_flag_follows_torch_profiler():
    def flag():
        return trace._autograd_profiler._is_profiler_enabled  # what span reads

    assert flag() is False and torch._C._autograd._profiler_enabled() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag() is True and torch._C._autograd._profiler_enabled() is True
    assert flag() is False and torch._C._autograd._profiler_enabled() is False


def _ranges(prof):
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.is_user_annotation), key=lambda r: r[1])


def test_decode_assets_opens_the_mp3_routes_ranges_under_one_call():
    assets = load_assets([MP3])
    decode_assets(assets, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_assets(assets, device="cpu")
    ranges = _ranges(prof)
    calls = [r for r in ranges if r[0].startswith("decode.call")]
    assert len(calls) == 1 and re.fullmatch(r"decode\.call\.\d+", calls[0][0])
    _, a, b = calls[0]
    inner = [r for r in ranges if r is not calls[0]]
    assert {n for n, _, _ in inner} == MP3_ROUTE
    assert all(a <= s and e <= b for _, s, e in inner)
    assert [n for n, _, _ in inner].count("mp3.requantize") == 1
    # each name's stat counts both calls; on the CPU no span reads device time
    assert trace.TRACE.stats["decode.call"].calls == 2
    for name in MP3_ROUTE:
        assert trace.TRACE.stats[name].calls == 2, name
    assert all(trace.TRACE.device_ms(n) is None for n in DEVICE_TIMED)


def test_to_device_counts_the_copies_and_bytes_it_was_handed():
    t = trace.to_device(np.arange(10, dtype=np.int32), "cpu")
    assert t.dtype == torch.int32 and t.tolist() == list(range(10))
    trace.to_device([1.0, 2.0], "cpu", torch.float64)
    trace.to_device(np.zeros(0, np.int16), "cpu")
    h2d = trace.TRACE.stats["h2d"]
    assert (h2d.calls, h2d.items) == (3, 40 + 16)
    # neither a CPU copy nor a CPU fetch blocks the host
    assert trace.to_host(t).tolist() == list(range(10))
    assert "sync" not in trace.TRACE.stats


def test_cli_decode_stats_prints_each_familys_audio_seconds(tmp_path, capsys):
    d = tmp_path / "assets"
    d.mkdir()
    pcm = np.zeros((4410, 2), np.int16)
    (d / "a.wav").write_bytes(make_wav(pcm, 44100))
    (d / "b.wav").write_bytes(make_wav(pcm[:2205, :1].copy(), 22050))
    for path in (MP3, FLAC):
        (d / os.path.basename(path)).write_bytes(open(path, "rb").read())
    (d / "c.xyz").write_bytes(b"not audio")
    assert cli.main(["--platform", "cpu", "decode", "--assets", str(d), "--stats"]) == 0
    out = capsys.readouterr().out
    batch = decode_assets(load_assets([MP3, FLAC]), device="cpu")
    want = {"wav": 0.2,
            "mp3": float(batch.valid_frames[0]) / float(batch.sample_rate[0]),
            "flac": float(batch.valid_frames[1]) / float(batch.sample_rate[1])}
    for fam, seconds in want.items():
        m = re.search(rf"^decode\.{fam}: 1 calls, [\d,.]+ ms, ([\d,.]+) items", out, re.M)
        assert m, (fam, out)
        assert m.group(1) == f"{seconds:,.3f}", (fam, m.group(1), seconds)
    assert re.search(r"^decode\.call: 1 calls", out, re.M)
    assert re.search(r"^h2d: \d+ calls, [\d,.]+ items", out, re.M)


def _tone_loop(device="cpu"):
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(44100) / 44100)).astype(np.float32)
    st = ES.empty_state(tone[None, :, None], [44100], [1], out_channels=1, device=device)
    return loop_mod.EngineLoop(st, ES.HostRegistry(["tone"]), 44100, 1,
                               sink=Sink("default", 44100, 1, realtime=False))


def _stat(name):
    s = trace.TRACE.stats.get(name)
    return (s.calls, s.items) if s is not None else (0, 0.0)


def test_the_live_loops_counters_count_a_known_script(monkeypatch):
    monkeypatch.setattr(loop_mod, "SPEC_DEPTH", 8)
    fetched = []
    real = loop_mod.to_host

    def counting(t):
        fetched.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(loop_mod, "to_host", counting)
    loop = _tone_loop()
    assert loop.submit("load tone") and loop.submit("start -v tone")
    loop.run_blocks(16)           # bursts 1, 2, 4, 8, 8: 23 rendered, 7 left over
    assert loop.submit("velocity tone 0.5")
    loop.run_blocks(1)            # the 7 go, one block of depth 1
    assert _stat("engine.command") == (3, 0.0)
    assert _stat("engine.block") == (17, 17 * loop_mod.PERIOD)
    assert _stat("engine.burst") == (6, 24.0)
    assert _stat("engine.discard") == (1, 7.0)
    # one drain a call that brought commands, one render and fetch a burst
    assert [_stat(n)[0] for n in ("engine.apply", "engine.render", "engine.fetch",
                                  "engine.sink", "engine.status")] == [2, 6, 6, 17, 2]
    # every burst and status snapshot reaches the host through to_host
    P = loop_mod.PERIOD
    assert fetched == [(P, 1), (2, P, 1), (4, P, 1), (8, P, 1), (8, P, 1), (5,),
                       (P, 1), (5,)]


#: commands of every verb but quit, each one the loop accepts
EVERY_VERB = ["tc x b:240", "load a -t s:3000", "load b -t c:x", "load c -t b:300",
              "group g -v a,b -t b:200", "seq a -p 4 -s 0,1 -c a:0.5 -j a:0.3",
              "seq g -p 3 -s 0 -c a:0.7", "trem b -p 2 -d 0.5", "env c -p 3 -d 0.4",
              "velocity c -0.5", "start -t x", "start -g g", "start -v c", "pause -v c",
              "resume -v c", "pause -g g", "resume -g g", "stop -t x", "stop -v a",
              "start -v a", "unload b"]


def _three_track_loop(device="cpu"):
    pcm = np.random.default_rng(0).uniform(-0.3, 0.3, (3, 44100, 2)).astype(np.float32)
    st = ES.empty_state(pcm, [44100, 30000, 20000], [2, 2, 1], out_channels=2, device=device)
    return loop_mod.EngineLoop(st, ES.HostRegistry(["a", "b", "c"]), 44100, 2,
                               sink=Sink("default", 44100, 2, realtime=False))


def test_the_engine_moves_host_values_through_the_trace_helpers(monkeypatch):
    fetched, put = [], []
    real_host, real_device = EC.to_host, EC.to_device

    def fetching(t):
        fetched.append(tuple(t.shape))
        return real_host(t)

    def putting(a, device, dtype=None):
        t = real_device(a, device, dtype)
        put.append(tuple(t.shape))
        return t

    monkeypatch.setattr(EC, "to_host", fetching)
    monkeypatch.setattr(EC, "to_device", putting)
    loop = _three_track_loop()
    assert all(loop.submit(line) for line in EVERY_VERB)
    loop.run_blocks(1)
    assert not loop.errors
    assert fetched and put  # the verbs read and set the device state through the helpers
    fetched.clear(), put.clear()
    h2d, rendered = _stat("h2d")[0], _stat("engine.burst")[1]
    assert loop.submit("seq c -p 4 -s 0,1 -c a:0.5")
    loop.run_blocks(16)
    rendered = _stat("engine.burst")[1] - rendered
    # its process slots and its tempo lane read; its kind and period set, then
    # its three step rows put
    assert fetched == [(ES.MAX_PROCS,), ()]
    assert put == [(), (), (ES.MAX_STEPS,), (ES.MAX_STEPS,), (ES.MAX_STEPS,)]
    # and nothing for the blocks rendered: the chance rolls take their
    # bounds by value
    assert rendered > 0
    assert _stat("h2d")[0] - h2d == len(put)


def test_the_live_loops_spans_open_under_a_profiler():
    loop = _tone_loop()
    loop.submit("load tone")
    loop.submit("start -v tone")
    loop.run_blocks(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.submit("velocity tone 2.0")
        loop.run_blocks(4)        # bursts 1, 2, then 1 of the next 4
    names = [n for n, _, _ in _ranges(prof)]
    assert names.count("engine.apply") == 1 and names.count("engine.status") == 1
    assert [n for n in names if n.startswith("engine.render")] == [
        "engine.render.1", "engine.render.2", "engine.render.4"]
    assert names.count("engine.fetch") == 3 and names.count("engine.sink") == 4


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _bench_assets(maker: str, config: dict, n: int):
    """``n`` files of a benchmark configuration's maker, at a test's size."""
    import importlib
    import json

    from audio_decoder_tpu_torch.io.assets import Asset

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = {"music_mp3": "fma-mp3", "speech_flac": "librispeech-flac"}[maker]
    with open(os.path.join(root, "h100bench", "configs", f"{name}.json")) as f:
        cfg = {**json.load(f), **config}
    mod = importlib.import_module(f"h100bench.inputs.{maker}")
    return [Asset(path=f"{name}-{i}.{mod.EXT}", name=f"{name}-{i}", ext=mod.EXT, data=b)
            for i, (b, _) in enumerate(mod.make_files(cfg, range(n)))]


def _synchronizing_ops(fn):
    """Run ``fn`` under torch's sync debug mode: (the stacks of the
    synchronizing operations torch warned of, the ``sync`` counter's rise)."""
    stacks = []
    before = trace.TRACE.stats["sync"].calls

    def hook(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            stacks.append(traceback.extract_stack()[:-1])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return stacks, trace.TRACE.stats["sync"].calls - before


@pytest.mark.cuda
def test_the_sync_counter_equals_torchs_count_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda")
    groups = {
        "fma-mp3": _bench_assets("music_mp3", {"clip_seconds": 6.0}, 4),
        "librispeech-flac": _bench_assets(
            "speech_flac", {"pool_files": 8, "mean_length_s": 3.0, "max_length_s": 6.0}, 8),
    }
    for name, assets in groups.items():
        decode_assets(assets, device=dev)  # warm: builds and constant tables
        stacks, counted = _synchronizing_ops(lambda: decode_assets(assets, device=dev))

        def counted_by_helpers(st):
            return any(f.name in ("to_device", "to_host")
                       and f.filename.endswith(os.path.join("utils", "trace.py")) for f in st)

        missed = ["\n".join(traceback.format_list(st[-6:])) for st in stacks
                  if not counted_by_helpers(st)]
        assert not missed, f"{name}: syncs the counter misses:\n" + "\n---\n".join(missed)
        assert counted == len(stacks), (name, counted, len(stacks))
        assert counted > 0


@pytest.mark.cuda
def test_the_mp3_dsp_spans_read_device_time_under_a_profiler_only():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda")
    assets = load_assets([MP3])
    decode_assets(assets, device=dev)
    torch.cuda.synchronize()
    assert all(trace.TRACE.device_ms(n) is None for n in DEVICE_TIMED)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        decode_assets(assets, device=dev)
    for name in DEVICE_TIMED:
        ms = trace.TRACE.device_ms(name)
        assert ms is not None and ms > 0, name
    assert trace.TRACE.device_ms("mp3.walk") is None


@pytest.mark.cuda
def test_the_live_loops_syncs_are_all_counted_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    monkeypatch.setattr(loop_mod, "SPEC_DEPTH", 8)
    warm = _three_track_loop("cuda")  # every kernel and burst depth warmed
    assert all(warm.submit(line) for line in EVERY_VERB)
    warm.run_blocks(40)
    loop = _three_track_loop("cuda")
    # its graphs captured at every burst depth first: a capture synchronizes
    # the card once by torch's recipe, and `engine.graph_capture` counts it
    captures = _stat("engine.graph_capture")[0]
    loop.run_blocks(15)
    assert _stat("engine.graph_capture")[0] - captures == 4
    bursts = _stat("engine.burst")[0]

    def play():
        assert all(loop.submit(line) for line in EVERY_VERB)
        loop.run_blocks(40)
        assert loop.submit("velocity a 1.5") and loop.submit("stop -g g")
        loop.run_blocks(12)

    stacks, counted = _synchronizing_ops(play)
    bursts = _stat("engine.burst")[0] - bursts
    assert not warm.errors and not loop.errors

    def counted_by_helpers(st):
        return any(f.name in ("to_device", "to_host")
                   and f.filename.endswith(os.path.join("utils", "trace.py")) for f in st)

    missed = ["\n".join(traceback.format_list(st[-6:])) for st in stacks
              if not counted_by_helpers(st)]
    assert not missed, "syncs the counter misses:\n" + "\n---\n".join(missed)
    assert counted == len(stacks)
    # at least a fetch a burst and the two status snapshots; the chance
    # rolls put nothing, and no burst captured a graph
    assert counted >= bursts + 2
    assert _stat("engine.graph_capture")[0] - captures == 4
    assert trace.TRACE.device_ms("engine.render") is None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        loop.run_blocks(8)
    assert trace.TRACE.device_ms("engine.render") > 0
