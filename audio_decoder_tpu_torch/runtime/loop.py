"""The playback main loop (≙ run_blast, runtime.rs:31-380).

Thread layout mirrors the reference: a reader thread feeds parsed-ready
command strings through the lock-free ring; the render thread drains the
ring, applies commands to the engine state, renders a block, and hands it
to the sink — drain → render → commit, the same cycle as the reference's
queue-pop → coordinate → mmap_commit (runtime.rs:320-380).  SIGTERM sets
an atomic flag the loop polls (runtime.rs:398-416); terminal state is
restored on every exit path.

Command transport: the native SPSC ring carries the raw line (parity with
the reference's CmdQueue, commands.rs:11-69 — the cross-thread signal),
while the parsed Command object rides a deque the ring tokens are paired
with 1:1 — Python can't move the typed Command through a C byte ring
without serialization, and the deque alone couldn't exercise the native
ring the ALSA build ships with.  submit() checks fullness BEFORE parse
(parse mutates the registry), which keeps the pairing invariant trivially
true: every successful push has exactly one pending Command.
"""

from __future__ import annotations

import collections
import dataclasses
import signal
import sys
import threading

import numpy as np
import torch

from ..engine import commands as EC
from ..engine.render import render_block, render_chain
from .native import CmdRing, RawTerminal, Sink

PERIOD = 128  # frames per block (≙ runtime.rs:282-284)

#: speculative render lookahead: when the command queue is idle, the
#: next D blocks are rendered in one burst of asynchronous device work
#: and copied to the host at once, mirroring the depth of the
#: reference's 4-period ALSA buffer (runtime.rs:278-289).
#: render_block is deterministic in its state argument, and a command's
#: effect starts at the next block SUNK (speculated-but-unsunk host
#: blocks are discarded the instant a command arrives), so playback
#: output is bit-identical to unspeculated rendering at every depth —
#: speculation only changes how many device→host copies (and host
#: synchronisations) pay for D blocks: 1 instead of D.  The default is
#: 2× the reference's buffer depth — the discard bound stays a fraction
#: of a typist's inter-command gap.  0 disables (tests pin equivalence).
#: Bursts ramp 1→2→4→…→SPEC_DEPTH across command-free refills and reset
#: to 1 on every command, so command-per-block input never renders more
#: than one discarded block per command.
SPEC_DEPTH = 8


class EngineLoop:
    """Drives the block renderer against a sink, fed by a command ring.
    Tensors stay on the state's device; each burst is copied to the host
    once."""

    def __init__(self, state, registry, sample_rate: int, channels: int,
                 sink: Sink | None = None, device: str = "default"):
        self.state = state
        self.reg = registry
        self.rate = sample_rate
        self.channels = channels
        self.proc = EC.CmdProcessor(registry, sample_rate)
        self.ring = CmdRing(256)
        self.sink = sink or Sink(device, sample_rate, channels)
        self.term = threading.Event()
        self.errors: list[str] = []
        self._pending: "collections.deque" = collections.deque()
        #: plain-Python snapshot for the prompt status line, refreshed by
        #: the render thread (never read device arrays from the UI thread)
        self.status: dict = {}
        #: bumps on every status refresh, so waiters can tell a stale
        #: snapshot (taken before their commands applied) from a fresh one
        self.status_seq = 0
        #: speculated [host block, device successor state] pairs
        #: continuing the chain from self.state (= state after the last
        #: SUNK block)
        self._spec: "collections.deque" = collections.deque()
        #: adaptive burst depth: starts at 1 and doubles per command-free
        #: refill up to SPEC_DEPTH, resetting on every command — so
        #: command-dense input (piped scripts) renders one block per
        #: command instead of speculating 8 and discarding 7 each time
        self._spec_ramp = 1

    def submit(self, line: str) -> bool:
        """Parse + enqueue (parse errors surface immediately on the caller's
        thread, like the reference's REPL-side validation).

        The fullness check runs BEFORE parse: parse has registry side
        effects (alloc/free of names), so rejecting a command after
        parsing would leave the host registry diverged from the engine
        state the command never reached."""
        line = line.strip()
        if not line:
            return True
        if len(self._pending) >= 250:  # ring holds 255; keep margin
            self.errors.append("command queue full; rejected")
            return False
        try:
            cmd = self.proc.parse(line)
        except EC.CmdErr as e:
            self.errors.append(str(e))
            return False
        if cmd.verb == "quit":
            self.term.set()
            return True
        self._pending.append(cmd)
        if not self.ring.try_push(line):  # unreachable given the margin
            self.errors.append("command queue full; dropped")
            self._pending.pop()
            return False
        return True

    def run_blocks(self, n_blocks: int, collect: bool = False) -> np.ndarray:
        """Render n blocks (drain → apply → render → sink per block).

        collect=True buffers and returns the rendered audio (offline
        render/tests); the real-time path skips the copies."""
        out: list = []
        for _ in range(n_blocks):
            if self.term.is_set():
                break
            got_cmd = False
            while self.ring.try_pop() is not None:
                got_cmd = True
                if self._pending:
                    cmd = self._pending.popleft()
                    try:
                        self.state = EC.apply(self.state, self.reg, cmd)
                    except EC.CmdErr as e:
                        self.errors.append(str(e))
                    except Exception as e:  # never kill the audio thread
                        self.errors.append(f"{cmd.verb}: {e!r}")
            if got_cmd:
                # commands take effect on the next SUNK block: discard
                # the speculated chain (it continued the pre-command
                # state) and re-render from the committed state
                self._spec.clear()
                self._spec_ramp = 1
            if not self._spec:
                # refill-on-empty: render_chain queues the whole burst
                # on the device and leaves it there, so D blocks cost
                # ONE device→host copy and one synchronisation, not D
                depth = max(min(self._spec_ramp, SPEC_DEPTH), 1)
                self._spec_ramp = min(self._spec_ramp * 2, max(SPEC_DEPTH, 1))
                if depth == 1:
                    blk, tail = render_block(
                        self.state, frames=PERIOD,
                        out_channels=self.channels)
                    self._spec.append([blk.cpu().numpy(), tail])
                else:
                    blks, acts, poss, clocks = render_chain(
                        self.state, frames=PERIOD,
                        out_channels=self.channels, depth=depth)
                    fetched = blks.cpu().numpy()  # one device→host copy
                    for i in range(depth):
                        # rendering advances only these three fields
                        # (render_block's st2 contract) — every other
                        # leaf is shared with the committed state
                        tail = dataclasses.replace(
                            self.state, v_active=acts[i], v_pos=poss[i],
                            clock=clocks[i])
                        self._spec.append([fetched[i], tail])
            block_np, self.state = self._spec.popleft()
            self.sink.write(block_np)
            if collect:
                out.append(block_np)
        self._snapshot_status()
        return (
            np.concatenate(out) if out else np.zeros((0, self.channels), np.float32)
        )

    def _snapshot_status(self):
        st = self.state
        # `draining` counts only non-sequenced voices: a running sequencer
        # retriggers its voice forever (render.py keeps seq-chained voices
        # active), so a play-out wait keyed on `playing` would never end.
        # It also mirrors the renderer's `sounding` group mask — a voice
        # in a PAUSED group is not sounding, never runs off its track,
        # and must not hold the EOF drain open.
        from ..engine.state import PROC_SEQ

        used = st.v_used
        active = st.v_active & used
        seq = (st.p_kind == PROC_SEQ).any(dim=1)
        grp = st.v_group
        g_ok = torch.where(grp >= 0, st.g_active[grp.clamp(min=0).long()], True)
        counts = torch.stack([
            used.sum(), active.sum(), (active & ~seq & g_ok).sum(),
            st.g_used.sum(), st.clock.long()]).cpu().tolist()  # one fetch
        voices, playing, draining, groups, clock = counts
        self.status = dict(
            voices=voices, playing=playing, draining=draining, groups=groups,
            clock_s=float(clock % (1 << 31)) / max(self.rate, 1),
        )
        self.status_seq += 1

    def install_sigterm(self):
        """SIGTERM → atomic flag → clean loop exit (≙ runtime.rs:398-416).
        Must run on the main thread."""
        try:
            signal.signal(signal.SIGTERM, lambda *_: self.term.set())
        except ValueError:
            pass  # not the main thread; caller owns signal setup

    def run_forever(self):
        try:
            while not self.term.is_set():
                self.run_blocks(64)
        finally:
            self.sink.close()


_MARKERS = "^X v>X<Z".replace(" ", "")  # spinner glyphs (runtime.rs:56-63)

_VERBS = (
    "load", "start", "pause", "resume", "stop", "unload", "velocity",
    "group", "tc", "seq", "trem", "env", "quit",
)
_FLAGS = ("-v", "-g", "-t", "-p", "-s", "-c", "-j", "-d")


def complete_line(reg, buf: list, cur: int) -> tuple[list, int]:
    """Tab completion over the shadow registry: verbs in first position,
    flags after '-', otherwise track/voice/group/context names.  Extends
    the current token to the candidates' longest common prefix (a REPL
    nicety beyond the reference's editor, runtime.rs:137-243)."""
    import os

    head = "".join(buf[:cur])
    start = head.rfind(" ") + 1
    token = head[start:]
    if start == 0:
        cands = [v for v in _VERBS if v.startswith(token)]
    elif token.startswith("-"):
        cands = [f for f in _FLAGS if f.startswith(token)]
    else:
        names = sorted(
            set(reg.tracks) | set(reg.voices) | set(reg.groups)
            | set(reg.contexts)
        )
        cands = [n for n in names if n.startswith(token)]
    if not cands:
        return buf, cur
    common = os.path.commonprefix(cands)
    if len(cands) == 1:
        common += " "
    add = common[len(token):]
    if not add:
        return buf, cur
    new = buf[:cur] + list(add) + buf[cur:]
    return new, cur + len(add)


def _read_line_raw(
    term: RawTerminal, history: list[str], prompt_state, reg=None
) -> str | None:
    """Raw-mode line editor: backspace, ←/→ cursor, ↑/↓ history, Tab
    completion, Ctrl-C (≙ the reference's key-reader thread,
    runtime.rs:137-243, plus completion it doesn't have)."""
    buf: list[str] = []
    cur = 0
    hist_idx = len(history)
    while True:
        prompt_state["line"] = "".join(buf)
        prompt_state["cursor"] = cur
        c = term.read_char()
        if c < 0:
            return None
        if c in (3, 4):  # Ctrl-C / Ctrl-D
            return None
        if c in (10, 13):  # Enter
            line = "".join(buf)
            if line:
                history.append(line)
            return line
        if c == 9 and reg is not None:  # Tab
            buf, cur = complete_line(reg, buf, cur)
            continue
        if c in (8, 127):  # backspace
            if cur > 0:
                buf.pop(cur - 1)
                cur -= 1
            continue
        if c == 27:  # ESC [ sequences: arrows + history
            if term.read_char() != ord("["):
                continue
            k = term.read_char()
            if k == ord("D") and cur > 0:  # left
                cur -= 1
            elif k == ord("C") and cur < len(buf):  # right
                cur += 1
            elif k == ord("A") and hist_idx > 0:  # up
                hist_idx -= 1
                buf = list(history[hist_idx])
                cur = len(buf)
            elif k == ord("B"):  # down
                hist_idx = min(hist_idx + 1, len(history))
                buf = list(history[hist_idx]) if hist_idx < len(history) else []
                cur = len(buf)
            continue
        if 32 <= c < 127:
            buf.insert(cur, chr(c))
            cur += 1


def _render_prompt(prompt_state, stop: threading.Event, loop=None):
    """Marker + line redraw thread (≙ runtime.rs:56-117: spinner every
    100 ms, line repaint at 15 ms), with a dim right-side status segment
    (voices playing / groups / clock) the reference doesn't have."""
    import time

    i = 0
    last_marker = 0.0
    while not stop.is_set():
        now = time.monotonic()
        if now - last_marker > 0.1:
            i = (i + 1) % len(_MARKERS)
            last_marker = now
        line = prompt_state.get("line", "")
        cur = prompt_state.get("cursor", len(line))
        sys.stdout.write(f"\r\x1b[2K{_MARKERS[i]} {line}")
        s = loop.status if loop is not None else {}
        if s:
            col = max(len(line) + 6, 44)
            sys.stdout.write(
                f"\x1b[s\x1b[{col}G\x1b[2m| {s['playing']}/{s['voices']} "
                f"voices  {s['groups']} grp  {s['clock_s']:.1f}s\x1b[0m\x1b[u"
            )
        back = len(line) - cur
        if back > 0:
            sys.stdout.write(f"\x1b[{back}D")
        sys.stdout.flush()
        stop.wait(0.015)
    sys.stdout.write("\r\x1b[2K")
    sys.stdout.flush()


#: piped-script play-out bound: even non-sequenced voices could loop (a
#: reverse voice at velocity 0 never reaches its end), so the EOF drain is
#: wall-clock bounded; SIGTERM remains the hard escape hatch.
DRAIN_TIMEOUT_S = 30.0


def repl(loop: EngineLoop, infile=None, outfile=None,
         drain_timeout: float = DRAIN_TIMEOUT_S):
    """REPL feeding the engine loop.  With a tty: raw-mode editing,
    history, spinner (≙ runtime.rs:39-243).  Piped input: line mode."""
    infile = infile or sys.stdin
    outfile = outfile or sys.stdout
    loop.install_sigterm()
    render_thread = threading.Thread(target=loop.run_forever, daemon=True)
    render_thread.start()
    interactive = hasattr(infile, "isatty") and infile.isatty()
    try:
        if interactive:
            history: list[str] = []
            prompt_state: dict = {"line": "", "cursor": 0}
            stop_prompt = threading.Event()
            painter = threading.Thread(
                target=_render_prompt, args=(prompt_state, stop_prompt, loop),
                daemon=True,
            )
            with RawTerminal() as term:
                painter.start()
                while not loop.term.is_set():
                    line = _read_line_raw(term, history, prompt_state, loop.reg)
                    if line is None:
                        break
                    if line:
                        ok = loop.submit(line)
                        if not ok and loop.errors:
                            sys.stdout.write(
                                f"\r\x1b[2Kerror: {loop.errors[-1]}\n"
                            )
                stop_prompt.set()
                painter.join(timeout=1)
        else:
            import time

            for line in infile:
                line = line.strip()
                if not line:
                    continue
                ok = loop.submit(line)
                if not ok and loop.errors:
                    print(f"error: {loop.errors[-1]}", file=outfile)
                if loop.term.is_set():
                    break
            # piped scripts end at EOF in microseconds — drain the queued
            # commands, then let anything still sounding play out before
            # tearing the render thread down (a script without `quit`
            # otherwise renders at most one block batch).  The wait keys
            # on `draining` (non-sequenced voices only — sequenced voices
            # never auto-clear) and is wall-clock bounded so a script that
            # leaves something running ends at EOF rather than hanging.
            deadline = time.monotonic() + drain_timeout
            while not loop.term.is_set() and loop._pending:
                if time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            # wait for one status snapshot taken AFTER the commands
            # applied — the initial {} snapshot would read draining=0
            seq0 = loop.status_seq
            while not loop.term.is_set() and loop.status_seq <= seq0:
                if time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            while (not loop.term.is_set()
                   and loop.status.get("draining", 0) > 0):
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        loop.term.set()
        render_thread.join(timeout=5)
        if render_thread.is_alive():
            # Still inside a render (host under load): leaving a daemon
            # thread inside a torch op makes interpreter finalization
            # unsafe — say so; the CLI entry hard-exits to sidestep it.
            print("warning: render thread did not stop within 5s",
                  file=sys.stderr)
