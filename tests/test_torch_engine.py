"""PyTorch port, the engine (state, commands, renderer, checkpoints)
against the JAX package on the CPU.

The same numpy tracks and command lines go through both packages.
Tolerances:

* trigger decisions (the frames where a click track sounds), ``v_active``
  after every block and the clock: equal;
* blocks: max abs 2e-6 (the mix sums over voices in another order, and
  ``cos``/``exp`` may differ by ulps); 6e-8 is the worst seen;
* ``v_pos``: within 1 ulp (the port rounds JAX's fused multiply-adds once
  through f64, which could round twice in a rare halfway case); every case
  here is exact;
* states after ``apply`` and checkpoint arrays: equal.

The port is also held against itself bit for bit: ``render_chain``
against sequential ``render_block``, and ``apply`` never writes into its
input state.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from audio_decoder_tpu.engine import checkpoint as JK
from audio_decoder_tpu.engine import commands as JC
from audio_decoder_tpu.engine import render as JR
from audio_decoder_tpu.engine import state as JS
from audio_decoder_tpu_torch.engine import checkpoint as PK
from audio_decoder_tpu_torch.engine import commands as PC
from audio_decoder_tpu_torch.engine import render as PR
from audio_decoder_tpu_torch.engine import state as PS

CPU = "cpu"
RATE = 1000  # the JAX tests' tiny rate
MAX_ABS = 2e-6


def _tracks(track_arrays):
    names = list(track_arrays)
    S = max(a.shape[0] for a in track_arrays.values())
    C = max(a.shape[1] for a in track_arrays.values())
    tracks = np.zeros((len(names), S, C), np.float32)
    lens, chs = [], []
    for i, n in enumerate(names):
        a = track_arrays[n]
        tracks[i, : a.shape[0], : a.shape[1]] = a
        lens.append(a.shape[0])
        chs.append(a.shape[1])
    return names, tracks, lens, chs


class Pair:
    """One engine in each package over the same tracks."""

    def __init__(self, track_arrays, rate=RATE):
        names, tracks, lens, chs = _tracks(track_arrays)
        C = tracks.shape[2]
        self.j = JS.empty_state(tracks, lens, chs, out_channels=C)
        self.p = PS.empty_state(tracks, lens, chs, out_channels=C, device=CPU)
        self.jreg, self.preg = JS.HostRegistry(names), PS.HostRegistry(names)
        self.jproc = JC.CmdProcessor(self.jreg, rate)
        self.pproc = PC.CmdProcessor(self.preg, rate)

    def run(self, lines):
        for line in lines:
            self.j = JC.apply(self.j, self.jreg, self.jproc.parse(line))
            self.p = PC.apply(self.p, self.preg, self.pproc.parse(line))
        assert_same_state(self.j, self.p)

    def render(self, frames, out_channels, n=1):
        """n blocks in both packages, held to the tolerances; returns the
        port's blocks concatenated."""
        out = []
        for _ in range(n):
            jb, self.j = JR.render_block(self.j, frames=frames,
                                         out_channels=out_channels)
            pb, self.p = PR.render_block(self.p, frames=frames,
                                         out_channels=out_channels)
            jb, pb = np.asarray(jb), pb.numpy()
            assert pb.shape == jb.shape and pb.dtype == np.float32
            assert np.abs(jb - pb).max(initial=0.0) <= MAX_ABS
            # where a click track sounds (a trigger), it sounds in both
            np.testing.assert_array_equal(jb != 0, pb != 0)
            assert_same_advance(self.j, self.p)
            out.append(pb)
        return np.concatenate(out)


def assert_same_advance(j, p):
    np.testing.assert_array_equal(np.asarray(j.v_active), p.v_active.numpy())
    assert int(j.clock) == int(p.clock)
    jp = np.asarray(j.v_pos).view(np.int32).astype(np.int64)
    pp = p.v_pos.numpy().view(np.int32).astype(np.int64)
    assert np.abs(jp - pp).max() <= 1


def _jax_arrays(st) -> dict:
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "track_rows"}


def assert_same_state(j, p):
    want, got = _jax_arrays(j), PS.to_numpy(p)
    assert sorted(want) == sorted(got)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _click(n=1000, head=(1.0,)):
    a = np.zeros((n, 1), np.float32)
    a[: len(head), 0] = head
    return a


# (tracks, command lines, frames per block, blocks, out channels)
SCENARIOS = {
    "load_start_ramp": (
        {"ramp": np.linspace(0.0, 0.5, 256, dtype=np.float32)[:, None]},
        ["load ramp", "start -v ramp"], 128, 3, 1),
    "velocity_reverse": (
        {"r": np.arange(256, dtype=np.float32)[:, None] / 512.0},
        ["load r", "velocity r -1.0", "start -v r"], 64, 5, 1),
    "fractional_velocity": (
        {"r": np.arange(64, dtype=np.float32)[:, None] / 64.0},
        ["load r", "velocity r 0.5", "start -v r"], 32, 5, 1),
    "odd_velocity": (
        {"r": (np.random.default_rng(1).standard_normal((3000, 2)) * 0.2
               ).astype(np.float32)},
        ["load r", "velocity r -0.8", "start -v r"], 128, 24, 2),
    "mono_fanout": (
        {"m": np.full((128, 1), 0.25, np.float32),
         "s": np.zeros((128, 2), np.float32)},
        ["load m", "start -v m"], 32, 2, 2),
    "mix_clamps": (
        {"a": np.full((128, 1), 0.9, np.float32),
         "b": np.full((128, 1), 0.9, np.float32)},
        ["load a", "load b", "start -v a", "start -v b"], 16, 2, 1),
    "seq_grid": (
        {"click": _click()},
        ["load click -t s:100", "seq click -p 4 -s 0,2", "start -v click"],
        128, 8, 1),
    "seq_chance_zero": (
        {"click": _click()},
        ["load click -t s:50", "seq click -p 2 -s 0,1 -c a:0.0",
         "start -v click"], 128, 4, 1),
    "seq_chance_half": (
        {"click": _click()},
        ["load click -t s:30", "seq click -p 4 -s 0,1,2,3 -c a:0.5,2:0.9",
         "start -v click"], 128, 12, 1),
    "group_transport": (
        {"a": np.full((64, 1), 0.1, np.float32),
         "b": np.full((64, 1), 0.2, np.float32)},
        ["load a", "load b", "group duo -v a,b", "start -g duo"], 16, 2, 1),
    "group_seq_shared_roll": (
        {"a": _click(head=(0.5,)), "b": _click(head=(0.25,))},
        ["load a", "load b", "group duo -v a,b",
         "seq duo -t s:100 -p 2 -s 0,1 -c a:0.5", "start -g duo"], 128, 15, 1),
    "group_tempo_inherit": (
        {"a": _click(), "b": _click(head=(0.5,))},
        ["load a", "load b", "group g -v a,b -t s:64", "load_later"], 128, 1, 1),
    "jitter_full": (
        {"click": _click()},
        ["load click -t s:100", "seq click -p 2 -s 0,1 -j a:1.0",
         "start -v click"], 128, 7, 1),
    "jitter_zero": (
        {"click": _click()},
        ["load click -t s:100", "seq click -p 4 -s 0,2 -j a:0.0",
         "start -v click"], 128, 7, 1),
    "trem": (
        {"c": np.full((4000, 1), 0.5, np.float32)},
        ["load c -t s:100", "trem c -p 4 -d 0.8", "start -v c"], 128, 15, 1),
    "seq_and_trem": (
        {"k": _click()},
        ["load k -t s:100", "seq k -p 1 -s 0", "trem k -p 4 -d 1.0",
         "start -v k"], 128, 9, 1),
    "env": (
        {"t": np.full((2048, 1), 0.5, np.float32)},
        ["load t -t s:64", "env t -p 4 -d 0.75", "start -v t"], 512, 1, 1),
    "seq_trem_env": (
        {"t": np.full((2048, 1), 0.5, np.float32)},
        ["load t -t s:64", "seq t -p 4 -s 0,2", "trem t -p 8 -d 0.5",
         "env t -p 2 -d 0.9", "start -v t"], 256, 3, 1),
    "context_tempo": (
        {"a": _click(), "b": _click(head=(0.3, 0.2))},
        ["tc beat s:70", "load a -t c:beat", "load b -t c:beat",
         "seq a -p 2 -s 0", "seq b -p 3 -s 1,2 -j a:0.4",
         "start -t beat", "start -v a", "start -v b"], 128, 8, 1),
    "four_channels": (
        {"q": (np.random.default_rng(9).standard_normal((512, 4)) * 0.1
               ).astype(np.float32)},
        ["load q", "start -v q"], 128, 4, 4),
    "out_wider_than_tracks": (
        {"s": (np.random.default_rng(2).standard_normal((700, 2)) * 0.3
               ).astype(np.float32)},
        ["load s", "velocity s 1.3", "start -v s"], 100, 5, 3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    tracks, lines, frames, n, out_ch = SCENARIOS[name]
    pair = Pair(tracks)
    if lines[-1] == "load_later":  # the group's tempo reaches members later
        pair.run(lines[:-1] + ["seq a -p 2 -s 0 -t g:g", "seq b -p 2 -s 1 -t g:g",
                               "start -g g"])
    else:
        pair.run(lines)
    audio = pair.render(frames, out_ch, n)
    assert np.abs(audio).max() > 0 or name == "seq_chance_zero"


def test_transport_sequence_matches_jax():
    """pause / resume / stop / unload / reload, rendering between each."""
    ramp = np.arange(512, dtype=np.float32)[:, None] / 1024.0
    pair = Pair({"r": ramp, "s": ramp[::-1].copy()})
    for lines in (["load r", "start -v r"], ["pause -v r"], ["resume -v r"],
                  ["load s", "group g -v r,s", "start -g g"], ["pause -g g"],
                  ["resume -g g"], ["stop -g g"], ["stop -v r"],
                  ["start -v r", "unload r"], ["load r", "start -v r"]):
        pair.run(lines)
        pair.render(64, 1, 2)


def test_jitter_stable_across_block_sizes():
    """The jitter hash is keyed by the absolute step number: 128- and
    64-frame blocks render the same audio, in both packages."""
    decay = _click(head=(1.0, 0.7, 0.4, 0.2))
    lines = ["load click -t s:64", "seq click -p 2 -s 0,1 -j a:0.9",
             "start -v click"]
    outs = []
    for frames, n in ((128, 7), (64, 14)):
        pair = Pair({"click": decay})
        pair.run(lines)
        outs.append(pair.render(frames, 1, n))
    assert np.array_equal(outs[0], outs[1])
    assert any(i % 64 != 0 for i in np.nonzero(outs[0][:, 0] >= 0.99)[0][1:])


def test_clock_wrap_matches_jax():
    """A clock past 2**31 wraps negative: the chance rolls fold in the
    negative int32 and the tempo arithmetic stays modular, as in JAX."""
    pair = Pair({"a": _click(), "b": np.full((600, 1), 0.25, np.float32)})
    pair.run(["load a -t s:37", "seq a -p 4 -s 0,1,3 -c a:0.6 -j a:0.3",
              "load b -t s:50", "trem b -p 2 -d 0.5"])
    c0 = 2**31 - 300
    pair.j = dataclasses.replace(pair.j, clock=np.int32(c0).__array__())
    pair.p = dataclasses.replace(pair.p, clock=torch.tensor(c0, dtype=torch.int32))
    pair.run(["start -v a", "start -v b"])
    pair.render(128, 1, 6)
    assert int(pair.p.clock) < 0


def test_fuzzed_command_streams_match_jax():
    rng = np.random.default_rng(0xE1)
    tracks = {n: (rng.standard_normal((900, 2)) * 0.2).astype(np.float32)
              for n in ("a", "b", "c")}
    pair = Pair(tracks, rate=44100)
    pool = ["start -v a", "start -v b", "start -v c", "velocity a -1.5",
            "velocity b 0.7", "velocity c 1.25", "stop -v a", "pause -v b",
            "resume -v b", "seq a -t s:40 -p 4 -s 0,2 -c a:0.7 -j a:0.5",
            "trem b -t s:33 -p 3 -d 0.6", "env c -t s:50 -p 2 -d 0.8",
            "start -t t", "pause -t t", "resume -g g", "pause -g g",
            "start -g g"]
    pair.run(["load a", "load b", "load c", "tc t s:45", "group g -v b,c"])
    for _ in range(30):
        line = pool[rng.integers(len(pool))]
        pair.run([line])
        pair.render(int(rng.choice([64, 100, 128])), 2, int(rng.integers(1, 3)))


def test_render_seconds_matches_jax():
    pair = Pair({"click": _click()})
    pair.run(["load click -t s:100", "seq click -p 4 -s 0,2", "start -v click"])
    ja, _ = JR.render_seconds(pair.j, 1.0, RATE, 1, block=128)
    pa, st = PR.render_seconds(pair.p, 1.0, RATE, 1, block=128)
    assert pa.shape == ja.shape == (896, 1)
    assert np.abs(ja - pa).max() <= MAX_ABS
    assert list(np.nonzero(pa[:, 0] >= 0.99)[0][:4]) == [0, 200, 400, 600]
    assert int(st.clock) == 896


BAD_LINES = [
    "blorp", "load nope", "start -v ghost", "velocity a", "seq a -p 4",
    "group g1", "tc t1 x:10", "tc t2 s:nope", "tc t2 s:inf", "tc t2 m:nan",
    "tc t2 b:inf", "seq a -p 4 -s 0,2 -c x:0.5", "seq a -p 4 -s 0,2 -c 1-z:0.5",
    "seq a -t s:100 -p 4 -s 0,2 -j y:0.5", "seq a -p abc -s 0",
    "seq a -p 1.5 -s 0", "seq a -p 4 -s 0,x", "trem a -p abc -d 0.5",
    "trem a -p 4 -d oops", "env a -p 4 -d 1.5", "seq a -p 99 -s 0",
    "seq a -p 4 -s 4", "start -x a", "unload", "",
]


@pytest.mark.parametrize("line", BAD_LINES)
def test_parser_errors_match_jax(line):
    pair = Pair({"a": np.zeros((8, 1), np.float32)})
    with pytest.raises(JC.CmdErr) as je:
        pair.jproc.parse(line)
    with pytest.raises(PC.CmdErr) as pe:
        pair.pproc.parse(line)
    assert str(pe.value) == str(je.value)


def test_parser_duplicates_and_ranges_match_jax():
    pair = Pair({"a": np.zeros((8, 1), np.float32)})
    for line in ["load a", "group g1 -v a", "tc t1 s:100"]:
        pair.run([line])
        for proc, err in ((pair.jproc, JC.CmdErr), (pair.pproc, PC.CmdErr)):
            with pytest.raises(err):
                proc.parse(line)
    cmd_j = pair.jproc.parse("seq a -t s:100 -p 4 -s 0,2 -c 0-99999999999:1.0")
    cmd_p = pair.pproc.parse("seq a -t s:100 -p 4 -s 0,2 -c 0-99999999999:1.0")
    assert dataclasses.asdict(cmd_j) == dataclasses.asdict(cmd_p)


def test_tempo_units_match_jax():
    for unit, val, rate in [("s", 441, 44100), ("m", 500, 44100),
                            ("b", 120, 44100), ("m", 0.7, 48000), ("b", 97.3, 22050)]:
        assert PC.convert_interval(unit, val, rate) == JC.convert_interval(unit, val, rate)
    with pytest.raises(PC.CmdErr):
        PC.convert_interval("x", 1, 44100)


@pytest.mark.parametrize("lines", [
    ["load a", "group g1 -v a", "seq g1 -p 2 -s 0"],
    ["load a", "seq a -p 4 -s 0"],
    ["load a", "trem a -p 4 -d 0.5"],
    ["load a", "group g1 -v a", "env g1 -p 2 -d 0.5"],
])
def test_apply_errors_match_jax(lines):
    pair = Pair({"a": np.zeros((64, 1), np.float32)})
    pair.run(lines[:-1])
    with pytest.raises(JC.CmdErr) as je:
        JC.apply(pair.j, pair.jreg, pair.jproc.parse(lines[-1]))
    with pytest.raises(PC.CmdErr) as pe:
        PC.apply(pair.p, pair.preg, pair.pproc.parse(lines[-1]))
    assert str(pe.value) == str(je.value)


def test_proc_slot_reuse_and_exhaustion():
    pair = Pair({"k": np.zeros((100, 1), np.float32)})
    pair.run(["load k -t s:50", "seq k -p 2 -s 0", "seq k -p 4 -s 1",
              "env k -p 2 -d 0.5", "env k -p 6 -d 0.9"])
    kinds = pair.p.p_kind[0].numpy()
    assert (kinds == PS.PROC_SEQ).sum() == 1 and (kinds == PS.PROC_ENV).sum() == 1
    assert int(pair.p.p_period[0, 0]) == 4
    full = dataclasses.replace(
        pair.p, p_kind=PC._set(pair.p.p_kind, 0, torch.full(
            (PS.MAX_PROCS,), PS.PROC_TREM, dtype=torch.int32)))
    with pytest.raises(PC.CmdErr, match="free process slot"):
        PC.apply(full, pair.preg, pair.pproc.parse("seq k -p 2 -s 0"))


ALL_VERBS = [
    "load a -t s:40", "load b", "load c -t s:30", "tc beat s:25",
    "load d -t c:beat", "group g -v b,c -t s:60", "velocity a -0.7",
    "seq a -p 4 -s 0,2 -c a:0.5,2:0.9 -j a:0.3", "seq g -p 2 -s 1",
    "trem c -p 4 -d 0.4", "env a -p 2 -d 0.6", "trem g -p 3 -d 0.2",
    "start -v a", "start -g g", "start -t beat", "start -v d", "pause -v a",
    "resume -v a", "pause -g g", "resume -g g", "pause -t beat",
    "resume -t beat", "stop -v d", "stop -g g", "stop -t beat",
    "unload b", "load b -t g:g", "velocity b 1.5", "start -v b",
]


def test_apply_never_writes_into_its_input_state():
    """Clone-on-write: every verb leaves every tensor of the input state
    unchanged (speculated states share them)."""
    rng = np.random.default_rng(4)
    tracks = {n: (rng.standard_normal((300, 2)) * 0.2).astype(np.float32)
              for n in "abcd"}
    pair = Pair(tracks)
    for line in ALL_VERBS:
        before = {k: v.clone() for k, v in vars(pair.p).items()
                  if isinstance(v, torch.Tensor)}
        old = pair.p
        pair.run([line])
        for k, v in before.items():
            assert torch.equal(getattr(old, k), v), (line, k)
        pair.render(50, 2)


def test_no_command_changes_the_rng_key():
    rng = np.random.default_rng(4)
    pair = Pair({n: (rng.standard_normal((300, 2)) * 0.2).astype(np.float32)
                 for n in "abcd"})
    key = pair.p.rng_key
    pair.run(ALL_VERBS)
    assert pair.p.rng_key is key
    np.testing.assert_array_equal(key.numpy(), [0, PS.RNG_SEED])


def test_render_chain_bit_identical_to_sequential(rng):
    """render_chain equals D sequential render_block calls bit for bit, and
    its (v_active, v_pos, clock) rebuild every intermediate state: the
    renderer advances only those three fields."""
    tracks = (rng.standard_normal((3, 4096, 2)) * 0.2).astype(np.float32)
    st = PS.empty_state(tracks, [4096, 3000, 4096], [2, 2, 2],
                        out_channels=2, device=CPU)
    reg = PS.HostRegistry(["a", "b", "c"])
    proc = PC.CmdProcessor(reg, 44100)
    for line in ["load a -t s:64", "seq a -p 4 -s 0,2 -c a:0.7 -j a:0.5",
                 "load b -t s:80", "velocity b -0.8", "trem b -p 8 -d 0.4",
                 "load c -t s:96", "env c -p 4 -d 0.6",
                 "start -v a", "start -v b", "start -v c"]:
        st = PC.apply(st, reg, proc.parse(line))
    D, F = 6, 128
    seq_blocks, seq_states = [], []
    cur = st
    for _ in range(D):
        blk, cur = PR.render_block(cur, frames=F, out_channels=2)
        seq_blocks.append(blk)
        seq_states.append(cur)
    blks, acts, poss, clocks = PR.render_chain(st, frames=F, out_channels=2,
                                               depth=D)
    assert torch.equal(blks, torch.stack(seq_blocks))
    for i in range(D):
        rec = dataclasses.replace(st, v_active=acts[i], v_pos=poss[i],
                                  clock=clocks[i])
        for name in PS.FIELD_DTYPES:
            assert torch.equal(getattr(rec, name), getattr(seq_states[i], name)), (
                i, name)
        nb, _ = PR.render_block(rec, frames=F, out_channels=2)
        want = (seq_blocks[i + 1] if i + 1 < D else PR.render_block(
            seq_states[-1], frames=F, out_channels=2)[0])
        assert torch.equal(nb, want)


def test_render_passes_every_other_tensor_through(rng):
    tracks = (rng.standard_normal((1, 500, 2)) * 0.2).astype(np.float32)
    st = PS.empty_state(tracks, [500], [2], out_channels=2, device=CPU)
    _, st2 = PR.render_block(st, frames=64, out_channels=2)
    for name in PS.FIELD_DTYPES:
        same = getattr(st2, name) is getattr(st, name)
        assert same == (name not in ("v_active", "v_pos", "clock")), name


def test_numpy_round_trip_and_jax_state_crossing(rng):
    """to_numpy / from_numpy carry a JAX state into the port exactly, and it
    renders as the JAX state does."""
    pair = Pair({"a": (rng.standard_normal((700, 2)) * 0.2).astype(np.float32)})
    pair.run(["load a -t s:33", "seq a -p 3 -s 0,1 -c a:0.5 -j a:0.2",
              "start -v a"])
    pair.render(128, 2, 2)
    crossed = PS.from_numpy(_jax_arrays(pair.j), CPU)
    assert_same_state(pair.j, crossed)
    pair.p = crossed
    pair.render(128, 2, 3)
    again = PS.from_numpy(PS.to_numpy(pair.p), CPU)
    for name in PS.FIELD_DTYPES:
        assert torch.equal(getattr(again, name), getattr(pair.p, name))
    assert again.track_c == pair.p.track_c == 2


def test_tracks_from_batch_matches_jax(rng):
    from audio_decoder_tpu.core.batch import AudioBatch as JB
    from audio_decoder_tpu_torch.core.batch import AudioBatch as TB

    pcm = rng.standard_normal((3, 50, 1)).astype(np.float32)
    meta = dict(sample_rate=np.full(3, 44100, np.int32),
                num_channels=np.ones(3, np.int32),
                bits_per_sample=np.full(3, 16, np.int32),
                valid_frames=np.array([50, 20, 35], np.int32),
                err=np.zeros(3, np.int32))
    jb = JB.from_pcm(pcm, **meta)
    pb = TB.from_pcm(torch.as_tensor(pcm), **{k: torch.as_tensor(v)
                                               for k, v in meta.items()})
    for C in (1, 2, 3):
        want = JS.tracks_from_batch(jb, C)
        got = PS.tracks_from_batch(pb, C)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_empty_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.empty_state(np.zeros((1, 8, 1), np.float32), [8], [1], out_channels=1)


# ------------------------------------------------------------ checkpoints


def _ck_pair(rng):
    pair = Pair({"k": _click(200), "m": (rng.standard_normal((400, 2)) * 0.2
                                         ).astype(np.float32)})
    pair.run(["load k -t s:100", "seq k -p 2 -s 0,1 -c a:0.5 -j a:0.25",
              "load m", "group g -v m -t s:70", "trem g -p 2 -d 0.3",
              "start -v k", "start -g g"])
    pair.render(128, 2, 2)
    return pair


def _same_registry(a, b):
    for attr in ("tracks", "voices", "groups", "contexts", "group_members",
                 "_free_v", "_free_g", "_free_x"):
        assert getattr(a, attr) == getattr(b, attr), attr


def test_checkpoint_files_have_the_jax_layout(tmp_path, rng):
    pair = _ck_pair(rng)
    JK.save_state(str(tmp_path / "j"), pair.j, pair.jreg)
    PK.save_state(str(tmp_path / "p"), pair.p, pair.preg)
    zj, zp = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert zj.files == zp.files
    for name in zj.files:
        assert zj[name].dtype == zp[name].dtype and zj[name].shape == zp[name].shape
        np.testing.assert_array_equal(zj[name], zp[name], err_msg=name)
    assert json.load(open(tmp_path / "j.json")) == json.load(open(tmp_path / "p.json"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_across_packages_and_render_the_same(
        tmp_path, rng, direction):
    pair = _ck_pair(rng)
    path = str(tmp_path / "ck")
    if direction == "jax_to_port":
        JK.save_state(path, pair.j, pair.jreg)
        st, reg = PK.load_state(path, device=CPU)
        assert_same_state(pair.j, st)
        _same_registry(pair.jreg, reg)
        pair.p, pair.preg = st, reg
    else:
        PK.save_state(path, pair.p, pair.preg)
        st, reg = JK.load_state(path)
        assert_same_state(st, pair.p)
        _same_registry(pair.preg, reg)
        pair.j, pair.jreg = st, reg
    pair.jproc.reg, pair.pproc.reg = pair.jreg, pair.preg
    pair.render(128, 2, 3)
    pair.run(["velocity m -1.0", "pause -v k"])
    pair.render(128, 2, 2)


def _as_v1(path, drop_jitter=False):
    z = dict(np.load(path + ".npz"))
    v1 = {k: v for k, v in z.items() if not k.startswith("p_")}
    v1["s_on"] = z["p_kind"][:, 0] == PS.PROC_SEQ
    v1["s_period"] = z["p_period"][:, 0]
    v1["s_stepmask"] = z["p_stepmask"][:, 0]
    v1["s_chance"] = z["p_chance"][:, 0]
    if not drop_jitter:
        v1["s_jitter"] = z["p_jitter"][:, 0]
    np.savez_compressed(path + ".npz", **v1)
    meta = json.load(open(path + ".json"))
    meta["version"] = 1
    json.dump(meta, open(path + ".json", "w"))


def _as_v2(path):
    """The v2 layout: planar tracks [T, S, C], no track_c."""
    z = dict(np.load(path + ".npz"))
    C = int(z.pop("track_c"))
    z["tracks"] = z["tracks"].reshape(z["tracks"].shape[0], -1, C)
    np.savez_compressed(path + ".npz", **z)
    meta = json.load(open(path + ".json"))
    meta["version"] = 2
    json.dump(meta, open(path + ".json", "w"))


def _strip(path):
    z = dict(np.load(path + ".npz"))
    for name in ("p_kind", "p_period", "p_stepmask", "p_chance", "p_jitter",
                 "p_depth"):
        z.pop(name)
    np.savez_compressed(path + ".npz", **z)


@pytest.mark.parametrize("case", ["v1", "v1_without_jitter", "v2", "stripped"])
def test_checkpoint_migrations_match_jax(tmp_path, case):
    """The v1 → v2 → v3 chain and the field defaults of
    tests/test_engine.py:375-452, loaded by both packages."""
    pair = Pair({"k": _click(200), "m": np.full((300, 2), 0.1, np.float32)})
    pair.run(["load k -t s:100", "seq k -p 2 -s 0,1 -c a:0.5", "load m"])
    path = str(tmp_path / "ck")
    PK.save_state(path, pair.p, pair.preg)
    {"v1": _as_v1, "v1_without_jitter": lambda p: _as_v1(p, drop_jitter=True),
     "v2": _as_v2, "stripped": _strip}[case](path)
    jst, _ = JK.load_state(path)
    pst, preg = PK.load_state(path, device=CPU)
    assert_same_state(jst, pst)
    assert preg.voices == pair.preg.voices
    if case == "stripped":
        assert not pst.p_kind.any()
    else:
        assert torch.equal(pst.p_kind, pair.p.p_kind)
        assert torch.equal(pst.p_chance, pair.p.p_chance)
    if case == "v1_without_jitter":
        assert not pst.p_jitter.any()


def test_checkpoint_errors(tmp_path, rng):
    with pytest.raises(FileNotFoundError):
        PK.load_state(str(tmp_path / "nothing"), device=CPU)
    pair = _ck_pair(rng)
    path = str(tmp_path / "ck")
    PK.save_state(path, pair.p, pair.preg)
    meta = json.load(open(path + ".json"))
    meta["version"] = 9
    json.dump(meta, open(path + ".json", "w"))
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        PK.load_state(path, device=CPU)
