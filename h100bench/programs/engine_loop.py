"""The live-loop program: the port's ``EngineLoop`` on a decoded asset
folder, driven as BLAST's REPL drives it.

``start`` writes the pool into a temporary asset folder and builds the
engine with the port's own ``cli._build_engine`` (the path ``cli render``
and ``cli repl`` take: ``decode_dir``, the consensus rate and channels,
``resample_to_consensus``, ``tracks_from_batch``, ``empty_state``,
``EngineLoop``), into an unpaced null sink.  Call 0 submits the opening
script; every later call submits one command of the seeded script
(``Script``), then renders ``n`` blocks with ``run_blocks(n, collect=True)``,
``n`` log-uniform over ``blocks_min``-``blocks_max`` from the seed and the
call.  The call ends in the burst's host fetch.

Its mix keys: ``voices_open``, ``voices_min``, ``voices_max``,
``groups_open``, ``group_size`` (members, least and most),
``contexts_open``, ``steps_per_minute`` (the tempo range of every
sequencer, context and group), ``blocks_min``, ``blocks_max``.  Its
configuration keys: ``max_voices`` and ``period`` (the port's capacity and
block, checked), ``check`` (``reference``, ``pcm_max_abs``,
``store_max_abs``).

A record holds the call's command lines, the blocks asked and sunk, whether
the blocks were finite and of their shape, the commands the loop refused
and the changes of the program's counters (``engine.*``, ``sync``) over the
call.  A kept output is the call's float32 blocks, the state it found, a
copy of the registry before its commands and the state it left.  The judge
renders each kept call again with the plain reference
(``reference/engine.py``) in worker processes, from the track store the
session saved when it closed, and compares the blocks and the state the
reference ends in (positions, active flags, clock: what the next call
starts from) with the loop's.  It also holds the store's rows of the
folder's WAV and AIFF files to their own samples (``store_max_abs``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from audio_decoder_tpu_torch import cli
from audio_decoder_tpu_torch.engine import commands as EC
from audio_decoder_tpu_torch.engine import state as ES
from audio_decoder_tpu_torch.runtime.loop import PERIOD
from audio_decoder_tpu_torch.utils.trace import TRACE
from h100bench import pool
from h100bench.reference import engine as reference

#: the counters a record keeps the change of: (calls, items) each
COUNTERS = ("sync", "engine.block", "engine.burst", "engine.discard", "engine.command")
#: the state fields a block advances, compared after each kept call
ADVANCED = ("v_pos", "v_active", "clock")


@dataclasses.dataclass
class Call:
    k: int
    lines: list[str]
    asked: int
    sunk: int
    ok: bool            # finite blocks, of their shape, as many as asked
    errors: int         # commands the loop refused in this call
    counts: dict        # counter → (calls, items) over the call
    rate: int
    period: int
    files: tuple = ()

    @property
    def audio_s(self) -> float:
        return self.sunk * self.period / self.rate


def pieces(config: dict, mix: dict) -> list[str]:
    for key in ("voices_open", "voices_min", "voices_max", "groups_open", "contexts_open",
                "blocks_min", "blocks_max"):
        int(mix[key])
    if not 0 < mix["steps_per_minute"][0] <= mix["steps_per_minute"][1]:
        raise ValueError("steps_per_minute is a range of positive rates")
    if not 1 <= mix["group_size"][0] <= mix["group_size"][1]:
        raise ValueError("group_size is a range of member counts")
    if not 1 <= int(mix["blocks_min"]) <= int(mix["blocks_max"]):
        raise ValueError("a live call renders blocks_min..blocks_max >= 1 blocks")
    if not int(mix["voices_min"]) <= int(mix["voices_open"]) <= int(mix["voices_max"]):
        raise ValueError("the opening script's voices lie in voices_min..voices_max")
    return [f"h100bench/reference/{config['check']['reference']}.py"]


def start(config: dict, mix: dict, inputs, seed: int, device: str, control: bool = False):
    """``control`` hands the judge the reference's blocks with the voice
    mix stored in bfloat16, and the reference's store rows in bfloat16, in
    the program's place."""
    return Session(config, mix, inputs, seed, device, control)


class Session:
    def __init__(self, config, mix, inputs, seed, device, control):
        if (int(config["max_voices"]), int(config["period"])) != (ES.MAX_VOICES, PERIOD):
            raise ValueError(f"the port renders {ES.MAX_VOICES} voices in {PERIOD}-frame "
                             "blocks; the configuration asks otherwise")
        self.config, self.mix, self.seed, self.control = config, mix, seed, control
        self.inputs = inputs
        self.period = PERIOD
        self.tmp = tempfile.mkdtemp(prefix="blast-live-")
        folder = os.path.join(self.tmp, "assets")
        os.makedirs(folder)
        for blob, info in zip(inputs.blobs, inputs.info):
            with open(os.path.join(folder, f"{info['name']}.{info['ext']}"), "wb") as f:
                f.write(blob)
        # the engine as `cli render` builds it; its report goes to stderr
        with contextlib.redirect_stdout(sys.stderr):
            self.loop, self.rate, self.channels = cli._build_engine(
                folder, True, realtime=False, device="default", platform=device)
        shutil.rmtree(folder)
        if (self.rate, self.channels) != (int(config["sample_rate"]), int(config["channels"])):
            raise ValueError(f"consensus {self.rate} Hz x {self.channels}, the configuration "
                             f"states {config['sample_rate']} x {config['channels']}")
        self.script = Script(mix, sorted(self.loop.reg.tracks), seed)
        self.tracks = self.rows = None
        self.errors = 0

    def blocks(self, k: int) -> int:
        lo, hi = int(self.mix["blocks_min"]), int(self.mix["blocks_max"])
        u = np.random.default_rng([self.seed, 8, k]).uniform(math.log(lo), math.log(hi + 1))
        return min(hi, max(lo, int(math.exp(u))))

    def call(self, k: int):
        loop = self.loop
        lines = self.script.opening() if k == 0 else [self.script.next()]
        n = self.blocks(k)
        found, reg = loop.state, copy.deepcopy(loop.reg)
        errors, before = len(loop.errors), _counts()
        for line in lines:
            loop.submit(line)
        audio = loop.run_blocks(n, collect=True)
        after = _counts()
        counts = {c: (after[c][0] - before[c][0], after[c][1] - before[c][1]) for c in COUNTERS}
        ok = audio.shape == (n * self.period, self.channels) and bool(np.isfinite(audio).all())
        record = Call(k, lines, n, audio.shape[0] // self.period, ok, len(loop.errors) - errors,
                      counts, self.rate, self.period)
        self.errors += record.errors
        return record, (audio, found, reg, loop.state)

    def to_host(self, record: Call, output):
        audio, found, reg, left = output
        state = {name: getattr(found, name).cpu().numpy()
                 for name in ES.FIELD_DTYPES if name != "tracks"}   # the store is saved once
        state["track_c"] = np.asarray(found.track_c)
        return audio, state, reg, {name: getattr(left, name).cpu().numpy() for name in ADVANCED}

    def close(self) -> None:
        """The track store goes to a file the reference reads, then the
        engine goes."""
        self.tracks = os.path.join(self.tmp, "tracks.npy")
        np.save(self.tracks, self.loop.state.tracks.cpu().numpy())
        lens = self.loop.state.track_len.cpu().numpy()
        self.rows = {name: (row, int(lens[row])) for name, row in self.loop.reg.tracks.items()}
        self.loop.sink.close()
        self.loop = None

    def judge(self, records: list[Call], kept: dict, workers: int):
        ks = sorted(kept)
        args = [(kept[q][1], kept[q][2], records[q].lines, records[q].asked, self.period,
                 self.channels, self.rate, self.tracks) for q in ks]
        tasks = [(__name__, "reference_call", a + ("float64",)) for a in args]
        if self.control:
            tasks += [(__name__, "reference_call", a + ("bfloat16",)) for a in args]
        stored = [(blob, info) for blob, info in zip(self.inputs.blobs, self.inputs.info)
                  if info["ext"] != "mp3"]
        tasks += [(__name__, "store_error", (self.tracks, self.rows.get(info["name"]), blob,
                                             self.rate, self.channels, self.control))
                  for blob, info in stored]
        try:
            refs = pool.parallel(tasks, workers)
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        store = max(refs[len(refs) - len(stored):], default=0.0)
        worst, moved = 0.0, 0
        for j, q in enumerate(ks):
            want, end = refs[j]
            got = refs[len(ks) + j][0] if self.control else kept[q][0]
            left = kept[q][3]
            moved += any(not np.array_equal(left[f], end[f]) for f in ADVANCED)
            if got.shape != want.shape:
                worst = math.inf
                continue
            worst = max(worst, float(np.abs(got.astype(np.float64) - want).max(initial=0.0)))
        bad = sum(not r.ok for r in records)
        failed = sum(1 for r in records if not r.ok or r.errors)
        check = self.config["check"]
        return {"command_errors": (self.errors, 0), "bad_blocks": (bad, 0),
                "pcm_max_abs": (worst, float(check["pcm_max_abs"])),
                "state_mismatches": (moved, 0),
                "store_max_abs": (store, float(check["store_max_abs"]))}, failed


def reference_call(state: dict, registry, lines: list[str], n_blocks: int, frames: int,
                   channels: int, rate: int, tracks,
                   mix_dtype: str = "float64") -> tuple[np.ndarray, dict]:
    """What a call of the live loop must sink, and the state it must leave,
    by the plain reference: the call's commands applied to the state it
    found with the port's parser and ``commands.apply`` on the CPU (host
    bookkeeping, held to the JAX package by tier-1 tests), then
    ``n_blocks`` blocks rendered by ``reference/engine.render``: (the
    blocks, the fields of ``ADVANCED`` after them).  ``tracks`` is the
    store or the path of a ``.npy`` file holding it (read memory-mapped);
    ``state`` may leave out ``tracks``."""
    if isinstance(tracks, str):
        tracks = np.load(tracks, mmap_mode="r")
    registry = copy.deepcopy(registry)   # parsing allocates names in it
    # commands read the track lengths, never the store: a one-frame stand-in
    st = ES.from_numpy({**state, "tracks": np.zeros((len(state["track_len"]), 1), np.float32)},
                       device="cpu")
    proc = EC.CmdProcessor(registry, rate)
    for line in lines:
        st = EC.apply(st, registry, proc.parse(line))
    audio, after = reference.render(ES.to_numpy(st), tracks, n_blocks, frames, channels,
                                    getattr(torch, mix_dtype))
    return audio, {name: after[name] for name in ADVANCED}


def store_error(tracks: str, row: tuple[int, int] | None, blob: bytes, rate: int,
                channels: int, control: bool = False) -> float:
    """The largest absolute difference between a WAV or AIFF file's row of
    the track store (``row``: its index and valid frames, None where the
    engine holds no such track; ``channels`` a frame) and the file's own
    samples at ``rate``
    (``reference.source_pcm``, through ``reference.resample`` where the
    file's rate differs).  A mono file is compared on the channel the
    render reads.  ``control`` puts the reference's row rounded to
    bfloat16 in the store's place."""
    x, src = reference.source_pcm(blob)
    want = x if src == rate else reference.resample(x, src, rate)
    if row is None or row[1] != want.shape[0]:
        return math.inf
    if control:
        got = torch.from_numpy(want).to(torch.bfloat16).double().numpy()
    else:
        got = np.load(tracks, mmap_mode="r")[row[0]].reshape(-1, channels).astype(np.float64)
    return float(np.abs(got[:want.shape[0], :want.shape[1]] - want).max(initial=0.0))


def _counts() -> dict:
    """Each counter's (calls, items) so far; zeros where the program keeps
    none (an earlier version)."""
    out = {}
    for c in COUNTERS:
        s = TRACE.stats.get(c)
        out[c] = (s.calls, s.items) if s is not None else (0, 0.0)
    return out


class Script:
    """The seeded command script, with a shadow of the registry so that
    every command is one the engine accepts: the opening script, then one
    command a call.  Every verb but ``quit``; between ``voices_min`` and
    ``voices_max`` voices loaded; a third of the velocities negative."""

    def __init__(self, mix: dict, tracks: list[str], seed: int):
        self.rng = np.random.default_rng([seed, 6])
        self.mix = mix
        self.tracks = tracks
        self.loaded: list[str] = []
        self.groups: list[str] = []
        self.contexts: list[str] = []

    # -- pieces of commands
    def _pick(self, items):
        return items[int(self.rng.integers(len(items)))]

    def _spm(self) -> float:
        """Sequencer steps a minute, log-uniform over the mix's range."""
        lo, hi = self.mix["steps_per_minute"]
        return math.exp(self.rng.uniform(math.log(lo), math.log(hi)))

    def _bpm(self) -> str:
        return f"b:{self._spm():.1f}"

    def _tempo(self) -> str:
        """A context's tempo half the time, else the voice's own, in steps
        a minute, milliseconds or samples."""
        r = self.rng.random()
        if self.contexts and r < 0.5:
            return f"c:{self._pick(self.contexts)}"
        if r < 0.7:
            return self._bpm()
        if r < 0.9:
            return f"m:{60000 / self._spm():.1f}"
        return f"s:{int(44100 * 60 / self._spm())}"

    def _seq(self, target: str, jitter: bool) -> str:
        period = int(self.rng.integers(2, 17))
        steps = np.sort(self.rng.choice(period, int(self.rng.integers(1, period + 1)),
                                        replace=False))
        if self.rng.random() < 0.5:
            chance = f"a:{self.rng.uniform(0.3, 0.95):.2f}"
        else:   # one step sure, the rest rolled
            chance = ",".join(f"{s}:{1.0 if j == 0 else self.rng.uniform(0.2, 0.9):.2f}"
                              for j, s in enumerate(steps))
        line = f"seq {target} -p {period} -s {','.join(map(str, steps))} -c {chance}"
        return line + (f" -j a:{self.rng.uniform(0.05, 0.6):.2f}" if jitter else "")

    def _gain(self, verb: str, target: str) -> str:
        period, depth = int(self.rng.integers(1, 9)), self.rng.uniform(0.2, 1.0)
        return f"{verb} {target} -p {period} -d {depth:.2f}"

    def _velocity(self, voice: str) -> str:
        sign = -1.0 if self.rng.random() < 1 / 3 else 1.0
        return f"velocity {voice} {sign * self.rng.uniform(0.25, 2.0):.3f}"

    def _load(self, name: str) -> str:
        self.loaded.append(name)
        return f"load {name} -t {self._tempo()}"

    # -- the script
    def opening(self) -> list[str]:
        """Contexts, voices, groups, sequencers (chance < 1 everywhere,
        jitter on two thirds of them), tremolo and envelopes on a quarter,
        a few velocities, then every context, group and voice started."""
        mix, rng = self.mix, self.rng
        lines = []
        for c in range(int(mix["contexts_open"])):
            self.contexts.append(f"tc{c:02d}")
            lines.append(f"tc tc{c:02d} {self._bpm()}")
        for name in rng.permutation(self.tracks)[:int(mix["voices_open"])]:
            lines.append(self._load(str(name)))
        order = [str(v) for v in rng.permutation(self.loaded)]
        members: dict[str, list[str]] = {}
        lo, hi = mix["group_size"]
        for g in range(int(mix["groups_open"])):
            size = int(rng.integers(lo, hi + 1))
            members[f"g{g:02d}"], order = order[:size], order[size:]
            self.groups.append(f"g{g:02d}")
            lines.append(f"group g{g:02d} -v {','.join(members[f'g{g:02d}'])} -t {self._bpm()}")
        free = [v for v in order if not v.startswith("stem")]   # stems play through
        for j, v in enumerate(free):
            lines.append(self._seq(v, jitter=j < 2 * len(free) // 3 + 1))
        for g in self.groups:
            lines.append(self._seq(g, jitter=True))
        for j, v in enumerate(order[:max(1, len(self.loaded) // 4)]):
            lines.append(self._gain("trem" if j % 2 == 0 else "env", v))
        for v in order[:max(1, len(self.loaded) // 8)]:
            lines.append(self._velocity(v))
        lines += [f"start -t {c}" for c in self.contexts]
        lines += [f"start -g {g}" for g in self.groups]
        lines += [f"start -v {v}" for v in order]
        return lines

    def next(self) -> str:
        mix, rng = self.mix, self.rng
        weights = {"start": 3.0, "pause": 1.5, "resume": 1.5, "stop": 1.0, "velocity": 2.0,
                   "seq": 3.0, "trem": 1.0, "env": 1.0}
        free = [t for t in self.tracks if t not in self.loaded]
        if len(self.loaded) < int(mix["voices_max"]) and free:
            weights["load"] = 2.0
        if len(self.loaded) > int(mix["voices_min"]):
            weights["unload"] = 2.0
        if len(self.groups) < ES.MAX_GROUPS and len(self.loaded) >= 2:
            weights["group"] = 0.4
        if len(self.contexts) < ES.MAX_CONTEXTS:
            weights["tc"] = 0.3
        verbs = sorted(weights)
        p = np.array([weights[v] for v in verbs])
        verb = verbs[int(rng.choice(len(verbs), p=p / p.sum()))]
        if verb == "load":
            return self._load(self._pick(free))
        if verb == "unload":
            v = self._pick(self.loaded)
            self.loaded.remove(v)
            return f"unload {v}"
        if verb in ("start", "pause", "resume", "stop"):
            r = rng.random()
            if r < 0.15 and self.groups:
                return f"{verb} -g {self._pick(self.groups)}"
            if r < 0.25 and self.contexts:
                return f"{verb} -t {self._pick(self.contexts)}"
            return f"{verb} -v {self._pick(self.loaded)}"
        if verb == "velocity":
            return self._velocity(self._pick(self.loaded))
        if verb == "group":
            name = f"g{len(self.groups):02d}"
            self.groups.append(name)
            lo, hi = mix["group_size"]
            size = min(len(self.loaded), int(rng.integers(lo, hi + 1)))
            mem = [str(v) for v in rng.choice(self.loaded, size, replace=False)]
            return f"group {name} -v {','.join(mem)} -t {self._bpm()}"
        if verb == "tc":
            name = f"tc{len(self.contexts):02d}"
            line = f"tc {name} {self._bpm()}"
            self.contexts.append(name)
            return line
        target = (self._pick(self.groups) if self.groups and rng.random() < 0.15
                  else self._pick(self.loaded))
        if verb == "seq":
            return self._seq(target, jitter=rng.random() < 2 / 3)
        return self._gain(verb, target)
