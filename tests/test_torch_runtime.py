"""PyTorch port, the runtime (native ring and sink, EngineLoop with
speculation, the REPL) and the CLI, on the CPU.

The native layer is the port's own build of ``native/runtime.cc``; a
failed build raises.  The loop renders into a capture or null sink.
Held to:

* the JAX package's loop on the same commands: collected blocks within
  max abs 2e-6 (tests/test_torch_engine.py's block tolerance);
* itself, bit for bit: speculation depths 1, 4 and 8 against depth 0, a
  fuzzed command stream included, and a checkpoint's continuation;
* the sink's ALSA geometry and data against a fake libasound built from
  tests/alsastub.c, as tests/test_runtime.py does;
* the CLI with ``--platform cpu``: decode, render of a script to WAV
  (within one LSB of the JAX package's render), inspect, and
  ``repl --offline`` fed from a pipe.
"""

import ctypes as C
import io
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from audio_decoder_tpu.engine import state as JS
from audio_decoder_tpu.runtime import loop as JL
from audio_decoder_tpu.runtime.native import Sink as JSink
from audio_decoder_tpu_torch import cli
from audio_decoder_tpu_torch.engine import state as ES
from audio_decoder_tpu_torch.runtime import loop as loop_mod
from audio_decoder_tpu_torch.runtime import native
from audio_decoder_tpu_torch.runtime.loop import PERIOD, EngineLoop
from audio_decoder_tpu_torch.runtime.native import CmdRing, Sink
from audio_decoder_tpu_torch.utils import build

from .synth import make_wav

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEREO_MP3 = os.path.join(REPO, "tests", "data", "torch_port",
                          "stereo_44k1_128k_js.mp3")


def _tone():
    return (0.5 * np.sin(2 * np.pi * 440 * np.arange(44100) / 44100)).astype(
        np.float32)[:, None]


def _loop_with_tone():
    st = ES.empty_state(_tone()[None], [44100], [1], out_channels=1, device=CPU)
    reg = ES.HostRegistry(["tone"])
    sink = Sink("default", 44100, 1, capture=True, realtime=False)
    return EngineLoop(st, reg, 44100, 1, sink=sink), sink


def _jax_loop_with_tone():
    st = JS.empty_state(_tone()[None], [44100], [1], out_channels=1)
    sink = JSink("default", 44100, 1, capture=True, realtime=False)
    return JL.EngineLoop(st, JS.HostRegistry(["tone"]), 44100, 1, sink=sink)


# ------------------------------------------------------------ native layer


def test_spsc_ring_roundtrip():
    ring = CmdRing(8)
    assert ring.try_pop() is None
    for i in range(7):  # capacity - 1 usable, like the reference
        assert ring.try_push(f"cmd{i}")
    assert not ring.try_push("overflow")
    got = []
    while (c := ring.try_pop()) is not None:
        got.append(c)
    assert got == [f"cmd{i}" for i in range(7)]


def test_spsc_ring_threaded_stress():
    import threading

    ring = CmdRing(64)
    n = 20000
    got = []

    def producer():
        i = 0
        while i < n:
            if ring.try_push(str(i)):
                i += 1

    def consumer():
        while len(got) < n:
            c = ring.try_pop()
            if c is not None:
                got.append(int(c))

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t1.start(); t2.start()
    t1.join(timeout=30); t2.join(timeout=30)
    assert got == list(range(n))


def test_native_runtime_is_built_from_the_ports_copy():
    assert native.available()
    path = native._build()
    assert path.startswith(build.BUILD_DIR) and "libblastrt-" in path


def test_failed_runtime_build_raises(monkeypatch, tmp_path):
    """No pure-Python fallback: without the library every class raises."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cc"))
    assert not native.available()
    with pytest.raises(build.BuildError):
        CmdRing(8)
    with pytest.raises(build.BuildError):
        Sink("default", 44100, 2, realtime=False)
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    with pytest.raises(build.BuildError, match="failed"):
        native.load_library()


@pytest.fixture(scope="module")
def alsa_stub_so(tmp_path_factory):
    """A private build of the fake libasound (tests/alsastub.c)."""
    so = str(tmp_path_factory.mktemp("alsastub") / "libalsastub.so")
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared",
                    os.path.join(REPO, "tests", "alsastub.c"), "-o", so],
                   check=True, capture_output=True, timeout=120)
    return so


@pytest.fixture()
def alsa_stub(monkeypatch, alsa_stub_so):
    lib = C.CDLL(alsa_stub_so)
    lib.stub_captured_samples.restype = C.c_long
    lib.stub_read_capture.argtypes = [C.POINTER(C.c_int16), C.c_long]
    monkeypatch.setenv("BLAST_ALSA_LIB", alsa_stub_so)
    lib.stub_reset()
    return lib


def _stub_capture(lib) -> np.ndarray:
    n = int(lib.stub_captured_samples())
    out = np.zeros(n, np.int16)
    lib.stub_read_capture(out.ctypes.data_as(C.POINTER(C.c_int16)), n)
    return out


def _i16(b):
    return np.clip(np.round(b * 32767.0), -32768, 32767).astype(np.int16)


def test_sink_mmap_geometry_and_data(alsa_stub):
    sink = Sink("hw:0,0", 44100, 2)
    assert sink.mode == "mmap" and sink.is_hardware
    lib = alsa_stub
    assert C.c_long.in_dll(lib, "stub_hw_period").value == 128
    assert C.c_long.in_dll(lib, "stub_hw_buffer").value == 512
    assert C.c_int.in_dll(lib, "stub_hw_access").value == 0  # MMAP_INTERLEAVED
    assert C.c_int.in_dll(lib, "stub_hw_format").value == 2  # S16_LE
    boundary = C.c_ulong.in_dll(lib, "stub_boundary_value").value
    assert C.c_ulong.in_dll(lib, "stub_sw_stop").value == boundary
    assert C.c_ulong.in_dll(lib, "stub_sw_start").value == 128
    assert C.c_ulong.in_dll(lib, "stub_sw_avail").value == 128
    rng = np.random.default_rng(3)
    blocks = [rng.uniform(-0.5, 0.5, (333, 2)).astype(np.float32)
              for _ in range(5)]
    for b in blocks:
        sink.write(b)
    want = np.concatenate([_i16(b) for b in blocks]).reshape(-1)
    np.testing.assert_array_equal(_stub_capture(lib), want)
    assert C.c_int.in_dll(lib, "stub_start_calls").value >= 1
    sink.close()


def test_sink_recovery_and_modes(alsa_stub):
    lib = alsa_stub
    sink = Sink("hw:0,0", 44100, 2)
    C.c_int.in_dll(lib, "stub_inject_epipe_avail").value = 2
    sink.write(np.full((256, 2), 0.25, np.float32))
    assert C.c_int.in_dll(lib, "stub_recover_calls").value == 2
    assert len(_stub_capture(lib)) == 256 * 2
    sink.close()
    lib.stub_reset()
    sink = Sink("hw:0,0", 44100, 2, mode="writei")
    assert sink.mode == "writei"
    C.c_int.in_dll(lib, "stub_inject_zero_writes").value = 3
    C.c_int.in_dll(lib, "stub_inject_epipe_writes").value = 1
    block = np.random.default_rng(5).uniform(-0.5, 0.5, (200, 2)).astype(np.float32)
    sink.write(block)
    assert C.c_int.in_dll(lib, "stub_recover_calls").value == 1
    np.testing.assert_array_equal(_stub_capture(lib), _i16(block).reshape(-1))
    sink.close()
    assert Sink("hw:0,0", 44100, 2, mode="mmap").mode == "mmap"


def test_sink_without_alsa_is_null(monkeypatch, tmp_path):
    monkeypatch.setenv("BLAST_ALSA_LIB", str(tmp_path / "no-libasound.so"))
    sink = Sink("default", 44100, 2)
    assert sink.mode == "null" and not sink.is_hardware
    t0 = time.perf_counter()
    sink.write(np.zeros((441, 2), np.float32))  # paced: 10 ms
    assert time.perf_counter() - t0 >= 0.008
    sink.close()
    assert Sink("default", 44100, 2, realtime=False).mode == "null"


# ------------------------------------------------------------ the loop


def test_engine_loop_commands_flow_through_ring():
    loop, sink = _loop_with_tone()
    assert loop.submit("load tone")
    assert loop.submit("start -v tone")
    audio = loop.run_blocks(8, collect=True)
    assert audio.shape == (8 * PERIOD, 1)
    assert np.abs(audio).max() > 0.3
    assert loop.submit("stop -v tone")
    assert np.all(loop.run_blocks(2, collect=True) == 0)
    assert len(sink.capture) == 10


def test_engine_loop_errors_quit_and_queue_full():
    loop, _ = _loop_with_tone()
    assert not loop.submit("load ghost")
    assert "ghost" in loop.errors[-1]
    assert not loop.submit("blorp")
    assert loop.submit("load tone")
    assert loop.submit("seq tone -p 4 -s 0")  # apply raises: no tempo
    assert loop.run_blocks(3, collect=True).shape == (3 * PERIOD, 1)
    assert any("requires a tempo" in e for e in loop.errors)
    for _ in range(250):
        loop._pending.append(None)
    assert not loop.submit("unload tone")
    assert "full" in loop.errors[-1]
    loop._pending.clear()
    assert loop.submit("start -v tone")
    assert np.abs(loop.run_blocks(2, collect=True)).max() > 0.3
    assert loop.submit("quit") and loop.term.is_set()


def test_engine_loop_status_snapshot():
    st = ES.empty_state(np.zeros((1, 64, 1), np.float32), [64], [1],
                        out_channels=1, device=CPU)
    loop = EngineLoop(st, ES.HostRegistry(["t"]), 1000, 1,
                      sink=Sink("default", 1000, 1, realtime=False))
    loop.submit("load t")
    loop.submit("group g -v t")
    loop.submit("start -v t")
    loop.run_blocks(4)
    assert loop.status["voices"] == 1 and loop.status["groups"] == 1
    assert loop.status["clock_s"] == pytest.approx(4 * PERIOD / 1000)
    assert all(isinstance(v, (int, float)) for v in loop.status.values())


LOOP_SCRIPT = [("load tone", 1), ("start -v tone", 6), ("velocity tone 2.0", 6),
               ("tc t s:40", 2), ("seq tone -t s:40 -p 4 -s 0,2 -c a:0.7 -j a:0.5", 9),
               ("trem tone -t s:40 -p 3 -d 0.8", 5), ("velocity tone -1.5", 4),
               ("group g -v tone", 1), ("pause -g g", 3), ("resume -g g", 5),
               ("stop -v tone", 2), ("start -v tone", 4)]


def test_engine_loop_matches_the_jax_loop():
    loop, _ = _loop_with_tone()
    jloop = _jax_loop_with_tone()
    for cmd, n in LOOP_SCRIPT:
        assert loop.submit(cmd) == jloop.submit(cmd)
        got = loop.run_blocks(n, collect=True)
        want = jloop.run_blocks(n, collect=True)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-6
        assert loop.status == jloop.status


def _spec_run(monkeypatch, depth, script):
    monkeypatch.setattr(loop_mod, "SPEC_DEPTH", depth)
    loop, _ = _loop_with_tone()
    chunks = []
    for cmd, n in script:
        loop.submit(cmd)
        chunks.append(loop.run_blocks(n, collect=True))
    return np.concatenate(chunks)


def test_speculative_lookahead_bit_identical(monkeypatch):
    base = _spec_run(monkeypatch, 0, LOOP_SCRIPT)
    assert np.abs(base).max() > 0.3
    for depth in (1, 4, 8):
        assert np.array_equal(_spec_run(monkeypatch, depth, LOOP_SCRIPT), base), depth


def test_speculative_lookahead_fuzz_equivalence(monkeypatch):
    rng = random.Random(0xB1A57)
    cmds = ["load tone", "start -v tone", "tc t s:40",
            "seq tone -t s:40 -p 4 -s 0,2 -c a:0.7 -j a:0.5",
            "trem tone -t s:40 -d 0.8", "velocity tone -1.5",
            "velocity tone 1.0", "group g -v tone", "pause -g g",
            "resume -g g", "stop -v tone", "start -v tone",
            "env tone -t s:30 -p 2 -d 0.5", "start -t t", "pause -t t"]
    script = [(rng.choice(cmds), rng.randint(1, 5)) for _ in range(40)]
    base = _spec_run(monkeypatch, 0, script)
    assert np.abs(base).max() > 0
    assert np.array_equal(_spec_run(monkeypatch, 8, script), base)


def test_speculative_lookahead_command_latency(monkeypatch):
    monkeypatch.setattr(loop_mod, "SPEC_DEPTH", 4)
    loop, _ = _loop_with_tone()
    loop.submit("load tone")
    loop.submit("start -v tone")
    a = loop.run_blocks(4, collect=True)
    assert np.abs(a[-PERIOD:]).max() > 0.3
    assert loop._spec, "lookahead empty — the discard path would not run"
    loop.submit("stop -v tone")
    assert np.all(loop.run_blocks(1, collect=True) == 0)


def test_speculative_lookahead_ramp_bounds_discards(monkeypatch):
    calls = {"block": 0, "chain": 0}
    real_block, real_chain = loop_mod.render_block, loop_mod.render_chain

    def counting_block(*a, **k):
        calls["block"] += 1
        return real_block(*a, **k)

    def counting_chain(*a, **k):
        calls["chain"] += k["depth"]
        return real_chain(*a, **k)

    monkeypatch.setattr(loop_mod, "render_block", counting_block)
    monkeypatch.setattr(loop_mod, "render_chain", counting_chain)
    monkeypatch.setattr(loop_mod, "SPEC_DEPTH", 8)
    loop, _ = _loop_with_tone()
    loop.submit("load tone")
    loop.submit("start -v tone")
    loop.run_blocks(1)
    calls.update(block=0, chain=0)
    for v in (0.5, 1.5, 0.75, 1.25, 1.0, 0.9, 1.1, 0.8):
        loop.submit(f"velocity tone {v}")
        loop.run_blocks(1)
    assert calls == {"block": 8, "chain": 0}  # one render per sunk block
    calls.update(block=0, chain=0)
    loop.run_blocks(16)  # an idle streak ramps 1, 2, 4, 8, 8
    assert calls["block"] + calls["chain"] <= 1 + 2 + 4 + 8 + 8


def test_engine_checkpoint_resume_sample_exact(tmp_path):
    from audio_decoder_tpu_torch.engine.checkpoint import load_state, save_state

    loop, _ = _loop_with_tone()
    loop.submit("load tone -t s:100")
    loop.submit("seq tone -p 3 -s 0,2 -c a:0.6 -j a:0.4")
    loop.submit("start -v tone")
    loop.run_blocks(3)
    path = str(tmp_path / "ckpt")
    save_state(path, loop.state, loop.reg)
    ref = loop.run_blocks(6, collect=True)
    st2, reg2 = load_state(path, device=CPU)
    loop2 = EngineLoop(st2, reg2, 44100, 1,
                       sink=Sink("default", 44100, 1, capture=True, realtime=False))
    np.testing.assert_array_equal(loop2.run_blocks(6, collect=True), ref)
    assert loop2.submit("pause -v tone")


def test_render_block_channel_contract():
    import dataclasses

    from audio_decoder_tpu_torch.engine.render import render_block

    tone = (0.4 * np.sin(2 * np.pi * 220 * np.arange(4410) / 44100)).astype(
        np.float32)[:, None]
    st = ES.empty_state(tone[None], [4410], [1], out_channels=2, device=CPU)
    st = dataclasses.replace(st, v_used=torch.ones(64, dtype=torch.bool),
                             v_active=torch.ones(64, dtype=torch.bool))
    blk, _ = render_block(st, frames=64, out_channels=2)
    assert blk.shape == (64, 2)
    assert blk.abs().max() > 0.01
    assert torch.equal(blk[:, 0], blk[:, 1])


def test_tab_completion_matches_jax():
    reg = ES.HostRegistry(["kick", "kick2", "snare"])
    reg.voices = {"kick": 0}
    reg.groups = {"drums": 0}
    for s in ["lo", "s", "st", "sta", "load ki", "load sn", "start -",
              "start -v dr", "load zz", "seq kick -", "q"]:
        buf = list(s)
        assert loop_mod.complete_line(reg, buf, len(buf)) == JL.complete_line(
            reg, buf, len(buf))
    assert "".join(loop_mod.complete_line(reg, list("sta"), 3)[0]) == "start "


def test_piped_eof_cases():
    """Piped scripts end at EOF: a running sequencer and a paused group do
    not hold the drain open, a plain voice plays out."""
    loop, _ = _loop_with_tone()
    t0 = time.monotonic()
    loop_mod.repl(loop, infile=io.StringIO(
        "load tone -t s:100\nseq tone -t s:100 -p 2 -s 0,1\nstart -v tone\n"),
        outfile=io.StringIO(), drain_timeout=2.0)
    assert time.monotonic() - t0 < 15.0 and loop.term.is_set()

    loop, _ = _loop_with_tone()
    t0 = time.monotonic()
    loop_mod.repl(loop, infile=io.StringIO(
        "load tone\ngroup g -v tone\nstart -g g\npause -g g\n"),
        outfile=io.StringIO(), drain_timeout=25.0)
    assert time.monotonic() - t0 < 20.0

    loop, sink = _loop_with_tone()
    out = io.StringIO()
    loop_mod.repl(loop, infile=io.StringIO("load tone\nbogus\nstart -v tone\n"),
                  outfile=out, drain_timeout=60.0)
    assert len(sink.capture) >= 345  # the 1 s tone played out
    assert loop.status.get("draining", 1) == 0
    assert "error: unknown command 'bogus'" in out.getvalue()


# ------------------------------------------------------------ the CLI


@pytest.fixture()
def kick_dir(tmp_path):
    rng = np.random.default_rng(5)
    pcm = np.clip(rng.standard_normal((4096, 2)) * 8000, -32768, 32767).astype(
        np.int16)
    d = tmp_path / "assets"
    d.mkdir()
    (d / "kick.wav").write_bytes(make_wav(pcm, 44100))
    (d / "snare.wav").write_bytes(make_wav(pcm[::-1].copy(), 44100))
    mono = np.clip(rng.standard_normal((3000, 1)) * 6000, -32768, 32767).astype(
        np.int16)
    (d / "hat.wav").write_bytes(make_wav(mono, 22050))
    return d, pcm


def test_cli_decode(kick_dir, capsys):
    d, _ = kick_dir
    assert cli.main(["--platform", "cpu", "decode", "--assets", str(d),
                     "--stats"]) == 0
    out = capsys.readouterr().out
    assert "kick: ok wav 44100 Hz 2 ch 4096 frames" in out
    assert "hat: ok wav 22050 Hz 1 ch 3000 frames" in out
    assert "consensus: 44100 Hz, 2 ch" in out and "per-file decode latency" in out


def test_cli_defaults_to_the_card(kick_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.parse_args(["decode", "--assets", "x"]).platform == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["decode", "--assets", str(kick_dir[0])])


SCRIPT = """# every verb
load kick -t s:300
load hat
load snare
tc beat b:240
group g -v hat,snare -t c:beat
seq kick -p 4 -s 0,1,3 -c a:0.7,3:0.4 -j a:0.25
trem hat -p 4 -d 0.5
env kick -p 2 -d 0.6
start -v kick
@0.03
start -g g
velocity hat -0.75
@0.02
pause -v kick
@0.01
resume -v kick
stop -g g
@0.02
unload hat
"""


@pytest.mark.parametrize("resample", [False, True])
def test_cli_render_script_to_wav_matches_jax(kick_dir, tmp_path, resample):
    from audio_decoder_tpu import cli as jcli
    from audio_decoder_tpu.codecs.registry import decode_paths as jdecode

    import audio_decoder_tpu_torch as P

    d, pcm = kick_dir
    script = tmp_path / "s.txt"
    script.write_text(SCRIPT)
    extra = ["--resample"] if resample else []
    args = cli.parse_args(["--platform", "cpu", "render", "--assets", str(d),
                           "--script", str(script), "--seconds", "0.01",
                           "--out", str(tmp_path / "p.wav")] + extra)
    assert args.fn(args) == 0
    assert jcli.main(["render", "--assets", str(d), "--script", str(script),
                      "--seconds", "0.01", "--out", str(tmp_path / "j.wav")]
                     + extra) == 0
    got = P.decode_paths([str(tmp_path / "p.wav")], device=CPU).file(0)
    want = jdecode([str(tmp_path / "j.wav")]).file(0)
    assert got.err == 0 and got.sample_rate == 44100 and got.num_channels == 2
    assert got.pcm.shape == want.pcm.shape
    # the written WAV holds exactly the blocks the sink captured
    np.testing.assert_array_equal(got.pcm, args.pcm.astype(np.float32) / 32768.0)
    diff = np.abs(got.pcm - np.asarray(want.pcm)) * 32768
    assert diff.max() <= 1  # int16 rounding of blocks within 2e-6
    assert np.abs(got.pcm).max() > 0.05


def test_cli_inspect_navigator(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("f\nn\n+5\n-2\nzz\nq\n"))
    assert cli.main(["inspect", STEREO_MP3]) == 0
    out = capsys.readouterr().out
    assert "<sync:" in out and "128kbps" in out and "commands:" in out


def test_cli_repl_offline_from_a_pipe(kick_dir):
    d, _ = kick_dir
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "audio_decoder_tpu_torch.cli", "--platform", "cpu",
         "repl", "--assets", str(d), "--offline"],
        input="load kick\nstart -v kick\nnope\nquit\n", cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "loaded 3 tracks @ 44100 Hz, 2 ch" in proc.stdout
    assert "sink: null (44100 Hz x 2)" in proc.stdout
    assert "error: unknown command 'nope'" in proc.stdout
