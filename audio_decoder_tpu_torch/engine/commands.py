"""Command grammar, parsing and state application.

The reference's REPL grammar (commands.rs:314-1277) drives 11 verbs —
Load, Start, Pause, Resume, Stop, Unload, Velocity, Group, Tc, Seq, Quit
(commands.rs:86-102) — parsed on the REPL thread into index-resolved
`Command` values that cross a lock-free queue into the audio thread.
Here the same split holds: `parse()` resolves names against the
`HostRegistry` and validates flags on the host; `apply()` turns a parsed
command into updates of the device `EngineArrays`, clone-on-write: a
changed tensor is replaced by an updated copy and no tensor of the input
state is written, because speculated render states share every tensor
but three with the committed state (runtime/loop.py).

Grammar (mirroring the reference's flags):
  load <track> [-t u:<unit>:<val> | -t c:<ctx> | -t g:<group>]
  start|pause|resume|stop -v <voice> | -g <group> | -t <ctx>
  unload <voice>
  velocity <voice> <float>            (signed: negative = reverse play)
  group <name> -v v1,v2,... [-t ...]
  tc <name> <unit>:<val>              (unit: s=samples m=millis b=bpm)
  seq <voice> -p <period> -s s1,s2,... [-c <chance-spec>] [-j <spec>]
  trem <voice> -p <period> -d <depth> [-t ...]   (beyond the reference)
  env <voice> -p <period> -d <depth> [-t ...]    (beyond the reference)
  q | quit

Each voice carries MAX_PROCS process slots (the reference's Vec<Process>
axis, processes.rs:12-50): `seq` fills the voice's existing SEQ slot or
the first free one; `trem` — a tempo-synced gain LFO cycling over
<period> tempo steps at <depth> in [0,1] — and `env` — a per-cycle
decay envelope (rhythmic gate) with the same flags — likewise, so a
voice can run a sequencer, a tremolo and an envelope together.

Chance mini-language (≙ commands.rs:1032-1168): `_` default-all 1.0,
`a:<p>` all steps p, `<n>:<p>` step n, `<n1>-<n2>:<p>` range.  The
jitter flag uses the same mini-language (default-all 0.0): each value is
the maximum trigger delay as a fraction of the tempo interval, applied
per step in the renderer — the reference parses -j but leaves it as an
empty stub (commands.rs:1125-1136); here it works.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .state import (
    MAX_PROCS, MAX_STEPS, PROC_ENV, PROC_NONE, PROC_SEQ, PROC_TREM,
    EngineArrays, HostRegistry,
)


class CmdErr(Exception):
    """User-facing command error (≙ CmdErr/StateErr, commands.rs:1296-1374)."""


@dataclasses.dataclass
class TempoSpec:
    kind: str  # "own" | "context" | "group" | "none"
    interval_samples: int = 0
    ref: int = -1  # context/group slot


@dataclasses.dataclass
class Command:
    verb: str
    voice: int = -1
    group: int = -1
    context: int = -1
    track: int = -1
    tempo: TempoSpec | None = None
    value: float = 0.0
    members: tuple = ()
    period: int = 0
    steps: tuple = ()
    chance: tuple = ()
    jitter: tuple = ()
    depth: float = 0.0
    name: str = ""


def convert_interval(unit: str, val: float, rate: int) -> int:
    """unit:val → samples (≙ TempoState::convert_interval,
    blast_time.rs:151-161)."""
    if not math.isfinite(val):
        raise CmdErr(f"tempo value must be finite, got {val!r}")
    if unit == "s":
        iv = int(val)
    elif unit == "m":
        iv = int(val * rate / 1000.0)
    elif unit == "b":
        if val <= 0:
            raise CmdErr("bpm must be positive")
        iv = int(rate * 60.0 / val)
    else:
        raise CmdErr(f"unknown tempo unit {unit!r} (s/m/b)")
    if iv <= 0:
        raise CmdErr("tempo interval must be >= 1 sample")
    return iv


class CmdProcessor:
    """Parse + apply (≙ CmdProcessor, commands.rs:314-342)."""

    def __init__(self, registry: HostRegistry, sample_rate: int):
        self.reg = registry
        self.rate = sample_rate

    # ------------------------------------------------------------- parse
    def parse(self, line: str) -> Command:
        toks = line.split()
        if not toks:
            raise CmdErr("empty command")
        verb = toks[0].lower()
        args = toks[1:]
        if verb in ("q", "quit"):
            return Command(verb="quit")
        if verb == "load":
            return self._parse_load(args)
        if verb in ("start", "pause", "resume", "stop"):
            return self._parse_transport(verb, args)
        if verb == "unload":
            return self._parse_unload(args)
        if verb == "velocity":
            return self._parse_velocity(args)
        if verb == "group":
            return self._parse_group(args)
        if verb == "tc":
            return self._parse_tc(args)
        if verb == "seq":
            return self._parse_seq(args)
        if verb in ("trem", "env"):
            return self._parse_trem(args, verb=verb)
        raise CmdErr(f"unknown command {verb!r}")

    def _find_voice(self, name: str) -> int:
        """Plain or dotted group.voice lookup (≙ commands.rs:1220-1261)."""
        if name in self.reg.voices:
            return self.reg.voices[name]
        if "." in name:
            gname, vname = name.split(".", 1)
            if gname in self.reg.groups and vname in self.reg.group_members.get(
                gname, ()
            ):
                return self.reg.voices[vname]
        raise CmdErr(f"no voice named {name!r}")

    def _parse_tempo_flag(self, spec: str) -> TempoSpec:
        if ":" not in spec:
            raise CmdErr(f"bad tempo spec {spec!r}")
        kind, rest = spec.split(":", 1)
        if kind == "c":
            if rest not in self.reg.contexts:
                raise CmdErr(f"no tempo context {rest!r}")
            return TempoSpec("context", ref=self.reg.contexts[rest])
        if kind == "g":
            if rest not in self.reg.groups:
                raise CmdErr(f"no group {rest!r}")
            return TempoSpec("group", ref=self.reg.groups[rest])
        try:
            val = float(rest)
        except ValueError as e:
            raise CmdErr(f"bad tempo value {rest!r}") from e
        return TempoSpec(
            "own", interval_samples=convert_interval(kind, val, self.rate)
        )

    def _parse_load(self, args: list[str]) -> Command:
        if not args:
            raise CmdErr("load: missing track name")
        name = args[0]
        if name not in self.reg.tracks:
            raise CmdErr(f"no track named {name!r}")
        if name in self.reg.voices:
            raise CmdErr(f"voice {name!r} already loaded")
        tempo = None
        i = 1
        while i < len(args):
            if args[i] in ("-t", "--tempo") and i + 1 < len(args):
                tempo = self._parse_tempo_flag(args[i + 1])
                i += 2
            else:
                raise CmdErr(f"load: unexpected {args[i]!r}")
        try:
            slot = self.reg.alloc_voice(name)
        except RuntimeError as e:
            raise CmdErr(f"load: {e}") from e
        return Command(
            verb="load", voice=slot, track=self.reg.tracks[name],
            tempo=tempo, name=name,
        )

    def _parse_transport(self, verb: str, args: list[str]) -> Command:
        if len(args) != 2 or args[0] not in ("-v", "-g", "-t"):
            raise CmdErr(f"{verb}: expected -v|-g|-t <name>")
        flag, name = args
        if flag == "-v":
            return Command(verb=verb, voice=self._find_voice(name))
        if flag == "-g":
            if name not in self.reg.groups:
                raise CmdErr(f"no group {name!r}")
            return Command(verb=verb, group=self.reg.groups[name])
        if name not in self.reg.contexts:
            raise CmdErr(f"no tempo context {name!r}")
        return Command(verb=verb, context=self.reg.contexts[name])

    def _parse_unload(self, args: list[str]) -> Command:
        if len(args) != 1:
            raise CmdErr("unload: expected voice name")
        slot = self._find_voice(args[0])
        name = next(n for n, s in self.reg.voices.items() if s == slot)
        self.reg.free_voice(name)
        for members in self.reg.group_members.values():
            if name in members:
                members.remove(name)
        return Command(verb="unload", voice=slot, name=name)

    def _parse_velocity(self, args: list[str]) -> Command:
        if len(args) != 2:
            raise CmdErr("velocity: expected <voice> <value>")
        try:
            val = float(args[1])
        except ValueError as e:
            raise CmdErr(f"velocity: bad value {args[1]!r}") from e
        return Command(verb="velocity", voice=self._find_voice(args[0]), value=val)

    def _parse_group(self, args: list[str]) -> Command:
        if not args:
            raise CmdErr("group: missing name")
        name = args[0]
        members: list[str] = []
        tempo = None
        i = 1
        while i < len(args):
            if args[i] in ("-v", "--voices") and i + 1 < len(args):
                members = args[i + 1].split(",")
                i += 2
            elif args[i] in ("-t", "--tempo") and i + 1 < len(args):
                tempo = self._parse_tempo_flag(args[i + 1])
                i += 2
            else:
                raise CmdErr(f"group: unexpected {args[i]!r}")
        if not members:
            raise CmdErr("group: -v v1,v2,... required")
        slots = tuple(self._find_voice(m) for m in members)
        try:
            gslot = self.reg.alloc_group(name)
        except (KeyError, RuntimeError) as e:
            raise CmdErr(f"group: {e}") from e
        self.reg.group_members[name] = list(members)
        return Command(
            verb="group", group=gslot, members=slots, tempo=tempo, name=name
        )

    def _parse_tc(self, args: list[str]) -> Command:
        if len(args) != 2 or ":" not in args[1]:
            raise CmdErr("tc: expected <name> <unit>:<val>")
        unit, val = args[1].split(":", 1)
        try:
            fval = float(val)
        except ValueError as e:
            raise CmdErr(f"tc: bad value {val!r}") from e
        iv = convert_interval(unit, fval, self.rate)
        try:
            slot = self.reg.alloc_context(args[0])
        except (KeyError, RuntimeError) as e:
            raise CmdErr(f"tc: {e}") from e
        return Command(
            verb="tc", context=slot,
            tempo=TempoSpec("own", interval_samples=iv), name=args[0],
        )

    def _parse_seq(self, args: list[str]) -> Command:
        if not args:
            raise CmdErr("seq: missing voice or group name")
        group = -1
        voice = -1
        if args[0] in self.reg.groups:
            group = self.reg.groups[args[0]]  # group-level sequencer
        else:
            voice = self._find_voice(args[0])
        period = 0
        steps: list[int] = []
        chance_spec = "_"
        jitter: tuple = ()
        tempo = None
        i = 1
        while i < len(args):
            if args[i] in ("-p", "--period") and i + 1 < len(args):
                try:
                    period = int(args[i + 1])
                except ValueError as e:
                    raise CmdErr(f"seq: bad period {args[i + 1]!r}") from e
                i += 2
            elif args[i] in ("-s", "--steps") and i + 1 < len(args):
                try:
                    steps = [int(s) for s in args[i + 1].split(",")]
                except ValueError as e:
                    raise CmdErr(f"seq: bad steps {args[i + 1]!r}") from e
                i += 2
            elif args[i] in ("-c", "--chance") and i + 1 < len(args):
                chance_spec = args[i + 1]
                i += 2
            elif args[i] in ("-j", "--jitter") and i + 1 < len(args):
                jitter = (args[i + 1],)
                i += 2
            elif args[i] in ("-t", "--tempo") and i + 1 < len(args):
                tempo = self._parse_tempo_flag(args[i + 1])
                i += 2
            else:
                raise CmdErr(f"seq: unexpected {args[i]!r}")
        if period <= 0 or period > MAX_STEPS:
            raise CmdErr(f"seq: -p period required (1..{MAX_STEPS})")
        if not steps:
            raise CmdErr("seq: -s s1,s2,... required")
        if any(s < 0 or s >= period for s in steps):
            raise CmdErr("seq: steps must lie in [0, period)")
        chance = self._parse_chance(chance_spec, steps, period)
        jit_vals = self._parse_chance(
            jitter[0] if jitter else "_", steps, period, default=0.0,
            what="jitter",
        )
        return Command(
            verb="seq", voice=voice, group=group, period=period,
            steps=tuple(steps), chance=tuple(chance),
            jitter=tuple(jit_vals), tempo=tempo,
        )

    def _parse_trem(self, args: list[str], verb: str = "trem") -> Command:
        """trem|env <voice|group> -p <period> -d <depth> [-t ...] — the
        tempo-synced gain processes (trem: LFO; env: per-cycle decay
        envelope), the further process kinds proving the extensibility
        the processes! macro designs for (processes.rs:12-50).  Both
        share the flag grammar."""
        if not args:
            raise CmdErr(f"{verb}: missing voice or group name")
        group = -1
        voice = -1
        if args[0] in self.reg.groups:
            group = self.reg.groups[args[0]]
        else:
            voice = self._find_voice(args[0])
        period = 0
        depth = -1.0
        tempo = None
        i = 1
        while i < len(args):
            if args[i] in ("-p", "--period") and i + 1 < len(args):
                try:
                    period = int(args[i + 1])
                except ValueError as e:
                    raise CmdErr(f"{verb}: bad period {args[i + 1]!r}") from e
                i += 2
            elif args[i] in ("-d", "--depth") and i + 1 < len(args):
                try:
                    depth = float(args[i + 1])
                except ValueError as e:
                    raise CmdErr(f"{verb}: bad depth {args[i + 1]!r}") from e
                i += 2
            elif args[i] in ("-t", "--tempo") and i + 1 < len(args):
                tempo = self._parse_tempo_flag(args[i + 1])
                i += 2
            else:
                raise CmdErr(f"{verb}: unexpected {args[i]!r}")
        if period <= 0:
            raise CmdErr(f"{verb}: -p period required (cycle in tempo steps)")
        if not 0.0 <= depth <= 1.0:
            raise CmdErr(f"{verb}: -d depth required, in [0,1]")
        return Command(
            verb=verb, voice=voice, group=group, period=period,
            depth=depth, tempo=tempo,
        )

    @staticmethod
    def _parse_chance(
        spec: str, steps: list[int], period: int,
        default: float = 1.0, what: str = "chance",
    ) -> list[float]:
        """`_` | `a:p` | `n:p` | `n1-n2:p` comma list → per-step values
        (≙ commands.rs:1032-1168); also reused for the jitter spec
        (default 0.0 = no jitter)."""
        chance = {s: default for s in steps}
        if spec == "_":
            return [chance.get(s, 0.0) for s in range(period)]
        for part in spec.split(","):
            if part == "_":
                continue
            if ":" not in part:
                raise CmdErr(f"{what}: bad entry {part!r}")
            sel, p = part.rsplit(":", 1)
            try:
                pv = float(p)
            except ValueError as e:
                raise CmdErr(f"{what}: bad value {p!r}") from e
            if not 0.0 <= pv <= 1.0:
                raise CmdErr(f"{what}: value must be in [0,1]")
            if sel == "a":
                for s in chance:
                    chance[s] = pv
            elif "-" in sel:
                lo, hi = sel.split("-", 1)
                try:
                    lo_i, hi_i = int(lo), int(hi)
                except ValueError as e:
                    raise CmdErr(f"{what}: bad step range {sel!r}") from e
                # iterate the (small) -s list, not the user-typed range —
                # `0-99999999999:1.0` must not spin the REPL thread
                for s in chance:
                    if lo_i <= s <= hi_i:
                        chance[s] = pv
            else:
                try:
                    s = int(sel)
                except ValueError as e:
                    raise CmdErr(f"{what}: bad step {sel!r}") from e
                if s not in chance:
                    raise CmdErr(f"{what}: step {s} not in -s list")
                chance[s] = pv
        return [chance.get(s, 0.0) for s in range(period)]


# ---------------------------------------------------------------- apply


def _set(t: torch.Tensor, idx, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[idx] = value`` (JAX's ``t.at[idx].set``)."""
    out = t.clone()
    out[idx] = value
    return out


def apply(st: EngineArrays, reg: HostRegistry, cmd: Command) -> EngineArrays:
    """Apply a parsed command to the device state (≙ Conductor::apply,
    engine.rs:83-101) between blocks; returns a new state and never writes
    into ``st``."""
    v, g, x = cmd.voice, cmd.group, cmd.context
    if cmd.verb == "load":
        st = dataclasses.replace(
            st,
            v_used=_set(st.v_used, v, True),
            v_active=_set(st.v_active, v, False),
            v_track=_set(st.v_track, v, cmd.track),
            v_pos=_set(st.v_pos, v, 0.0),
            v_vel=_set(st.v_vel, v, 1.0),
            v_gain=_set(st.v_gain, v, 1.0),
            v_group=_set(st.v_group, v, -1),
        )
        return _bind_tempo_voice(st, reg, v, cmd.tempo)
    if cmd.verb == "unload":
        return dataclasses.replace(
            st,
            v_used=_set(st.v_used, v, False),
            v_active=_set(st.v_active, v, False),
            p_kind=_set(st.p_kind, v, PROC_NONE),  # clear the whole chain
            v_tempo=_set(st.v_tempo, v, -1),
        )
    if cmd.verb == "velocity":
        return dataclasses.replace(st, v_vel=_set(st.v_vel, v, cmd.value))
    if cmd.verb in ("start", "resume", "pause", "stop"):
        return _transport(st, reg, cmd)
    if cmd.verb == "group":
        st = dataclasses.replace(
            st,
            g_used=_set(st.g_used, g, True),
            g_active=_set(st.g_active, g, False),
        )
        vg = st.v_group
        for m in cmd.members:
            vg = _set(vg, m, g)
        st = dataclasses.replace(st, v_group=vg)
        if cmd.tempo is not None and cmd.tempo.kind == "own":
            lane = reg.group_lane(g)
            st = dataclasses.replace(
                st,
                t_interval=_set(st.t_interval, lane, cmd.tempo.interval_samples),
                g_tempo=_set(st.g_tempo, g, lane),
            )
            # members flagged "inherit from group" (TBD mode) pick it up
            vt = st.v_tempo
            for m in cmd.members:
                if int(st.v_tempo[m]) == -2:
                    vt = _set(vt, m, lane)
            st = dataclasses.replace(st, v_tempo=vt)
        return st
    if cmd.verb == "tc":
        lane = reg.context_lane(x)
        return dataclasses.replace(
            st, t_interval=_set(st.t_interval, lane, cmd.tempo.interval_samples)
        )
    if cmd.verb == "seq":
        mask = np.zeros(MAX_STEPS, bool)
        ch = np.zeros(MAX_STEPS, np.float32)
        jt = np.zeros(MAX_STEPS, np.float32)
        for s in cmd.steps:
            mask[s] = True
        for s, p in enumerate(cmd.chance):
            ch[s] = p
        for s, p in enumerate(cmd.jitter):
            jt[s] = p
        if cmd.group >= 0:
            # group-level sequencer: every member voice follows the group
            # tempo lane and shares its chance roll (lane-keyed RNG)
            targets = [
                int(i) for i in np.nonzero(st.v_group.cpu().numpy() == cmd.group)[0]
            ]
            lane = reg.group_lane(cmd.group)
            if cmd.tempo is not None and cmd.tempo.kind == "own":
                st = dataclasses.replace(
                    st,
                    t_interval=_set(st.t_interval, lane,
                        cmd.tempo.interval_samples
                    ),
                    g_tempo=_set(st.g_tempo, cmd.group, lane),
                )
            if int(st.g_tempo[cmd.group]) < 0:
                raise CmdErr("seq on a group requires a group tempo (-t)")
        else:
            targets = [v]
        for t in targets:
            slot = _proc_slot(st, t, PROC_SEQ)
            st = dataclasses.replace(
                st,
                p_kind=_set(st.p_kind, (t, slot), PROC_SEQ),
                p_period=_set(st.p_period, (t, slot), cmd.period),
                p_stepmask=_set(st.p_stepmask, (t, slot), torch.as_tensor(mask)),
                p_chance=_set(st.p_chance, (t, slot), torch.as_tensor(ch)),
                p_jitter=_set(st.p_jitter, (t, slot), torch.as_tensor(jt)),
            )
            if cmd.group >= 0:
                st = dataclasses.replace(
                    st, v_tempo=_set(st.v_tempo, t, reg.group_lane(cmd.group))
                )
            elif cmd.tempo is not None:
                st = _bind_tempo_voice(st, reg, t, cmd.tempo)
        # a voice sequencer with no tempo lane would never fire (the
        # renderer gates triggers on v_tempo >= 0); -2 = awaiting group
        # inheritance is allowed, bare -1 is a user error
        if cmd.group < 0 and int(st.v_tempo[v]) == -1:
            raise CmdErr(
                "seq on a voice requires a tempo (load -t ... or seq -t ...)"
            )
        return st
    if cmd.verb in ("trem", "env"):
        kind = PROC_TREM if cmd.verb == "trem" else PROC_ENV
        if cmd.group >= 0:
            targets = [
                int(i) for i in np.nonzero(st.v_group.cpu().numpy() == cmd.group)[0]
            ]
            lane = reg.group_lane(cmd.group)
            if cmd.tempo is not None and cmd.tempo.kind == "own":
                st = dataclasses.replace(
                    st,
                    t_interval=_set(st.t_interval, lane,
                        cmd.tempo.interval_samples
                    ),
                    g_tempo=_set(st.g_tempo, cmd.group, lane),
                )
            if int(st.g_tempo[cmd.group]) < 0:
                raise CmdErr(f"{cmd.verb} on a group requires a group tempo (-t)")
        else:
            targets = [v]
        for t in targets:
            slot = _proc_slot(st, t, kind)
            st = dataclasses.replace(
                st,
                p_kind=_set(st.p_kind, (t, slot), kind),
                p_period=_set(st.p_period, (t, slot), cmd.period),
                p_depth=_set(st.p_depth, (t, slot), cmd.depth),
            )
            if cmd.group >= 0:
                st = dataclasses.replace(
                    st, v_tempo=_set(st.v_tempo, t, reg.group_lane(cmd.group))
                )
            elif cmd.tempo is not None:
                st = _bind_tempo_voice(st, reg, t, cmd.tempo)
        # the process phase derives from the voice's tempo lane; same
        # tempo requirement as seq
        if cmd.group < 0 and int(st.v_tempo[v]) == -1:
            raise CmdErr(
                f"{cmd.verb} on a voice requires a tempo "
                f"(load -t ... or {cmd.verb} -t ...)"
            )
        return st
    if cmd.verb == "quit":
        return st
    raise CmdErr(f"unhandled verb {cmd.verb!r}")


def _proc_slot(st: EngineArrays, v: int, kind: int) -> int:
    """Slot index for installing a process of `kind` on voice v: reuse
    the voice's existing slot of that kind (re-issuing `seq`/`trem`
    reconfigures it, like the reference replacing its Seq) else claim
    the first free slot."""
    kinds = st.p_kind[v].cpu().numpy()
    same = np.nonzero(kinds == kind)[0]
    if same.size:
        return int(same[0])
    free = np.nonzero(kinds == PROC_NONE)[0]
    if free.size:
        return int(free[0])
    raise CmdErr(f"voice has no free process slot (max {MAX_PROCS})")


def _bind_tempo_voice(st, reg, v: int, tempo: TempoSpec | None):
    if tempo is None:
        return st
    if tempo.kind == "own":
        lane = reg.voice_lane(v)
        return dataclasses.replace(
            st,
            t_interval=_set(st.t_interval, lane, tempo.interval_samples),
            v_tempo=_set(st.v_tempo, v, lane),
        )
    if tempo.kind == "context":
        return dataclasses.replace(
            st, v_tempo=_set(st.v_tempo, v, reg.context_lane(tempo.ref))
        )
    if tempo.kind == "group":
        lane = int(st.g_tempo[tempo.ref]) if tempo.ref >= 0 else -1
        if lane < 0:
            # group tempo not defined yet: mark "inherit later" (TBD mode,
            # blast_time.rs:66-74)
            return dataclasses.replace(st, v_tempo=_set(st.v_tempo, v, -2))
        return dataclasses.replace(st, v_tempo=_set(st.v_tempo, v, lane))
    return st


def _transport(st: EngineArrays, reg: HostRegistry, cmd: Command) -> EngineArrays:
    verb = cmd.verb
    if cmd.voice >= 0:
        v = cmd.voice
        lane = int(st.v_tempo[v])
        if verb == "start":
            end = st.track_len[st.v_track[v].long()] - 1
            reset = torch.where(st.v_vel[v] < 0, end.to(torch.float32), 0.0)
            st = dataclasses.replace(
                st,
                v_active=_set(st.v_active, v, True),
                v_pos=_set(st.v_pos, v, reset),
            )
            if lane >= 0:
                st = dataclasses.replace(
                    st,
                    t_active=_set(st.t_active, lane, True),
                    t_start=_set(st.t_start, lane, st.clock),
                )
            return st
        if verb == "pause":
            return dataclasses.replace(st, v_active=_set(st.v_active, v, False))
        if verb == "resume":
            return dataclasses.replace(st, v_active=_set(st.v_active, v, True))
        st = dataclasses.replace(  # stop
            st,
            v_active=_set(st.v_active, v, False),
            v_pos=_set(st.v_pos, v, 0.0),
        )
        if lane >= 0:
            st = dataclasses.replace(st, t_active=_set(st.t_active, lane, False))
        return st
    if cmd.group >= 0:
        g = cmd.group
        members = st.v_group == g
        lane = int(st.g_tempo[g])
        if verb == "start":
            st = dataclasses.replace(
                st,
                g_active=_set(st.g_active, g, True),
                v_active=torch.where(members, True, st.v_active),
                v_pos=torch.where(members, 0.0, st.v_pos),
            )
            if lane >= 0:
                st = dataclasses.replace(
                    st,
                    t_active=_set(st.t_active, lane, True),
                    t_start=_set(st.t_start, lane, st.clock),
                )
            return st
        if verb == "pause":
            return dataclasses.replace(st, g_active=_set(st.g_active, g, False))
        if verb == "resume":
            return dataclasses.replace(st, g_active=_set(st.g_active, g, True))
        st = dataclasses.replace(
            st,
            g_active=_set(st.g_active, g, False),
            v_active=torch.where(members, False, st.v_active),
            v_pos=torch.where(members, 0.0, st.v_pos),
        )
        if lane >= 0:
            st = dataclasses.replace(st, t_active=_set(st.t_active, lane, False))
        return st
    # tempo context transport
    lane = reg.context_lane(cmd.context)
    if verb == "start":
        return dataclasses.replace(
            st,
            t_active=_set(st.t_active, lane, True),
            t_start=_set(st.t_start, lane, st.clock),
        )
    if verb in ("pause", "stop"):
        return dataclasses.replace(st, t_active=_set(st.t_active, lane, False))
    return dataclasses.replace(st, t_active=_set(st.t_active, lane, True))
