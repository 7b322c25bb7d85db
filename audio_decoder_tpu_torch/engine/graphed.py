"""The render chain as CUDA graphs: one replay per speculation burst.

On the card, the live loop (``runtime/loop.EngineLoop``) renders bursts of
1, 2, 4 and 8 blocks with ``render_chain`` over states whose shapes never
change: ~587 small torch ops a block, which the host issues far more
slowly than the card runs them.  ``GraphedChain`` captures
``render_chain`` once per depth with torch's CUDA graphs and replays it,
so a burst costs the host a copy-in, one graph launch and three clones.
The graph runs the same kernels in the same order on the same values, so
every block and every advanced field is bit for bit the eager chain's.

* Static inputs: every field a command can replace (all but ``tracks``
  and ``rng_key``) has a static copy that the graph reads.  Before each
  replay the state's fields are copied into them as raw bits, one
  ``torch._foreach_copy_`` per element size (``copy_bits``).
* The store (``tracks``) and the key are read in place, by address, and
  never copied: no command replaces them.  The jitter seed
  (``render._jitter_seed``) is derived before the capture, and the graph
  reads the cached seed tensor.
* A graph is keyed on its depth, the identity of ``tracks`` and
  ``rng_key``, every copied field's shape and dtype, ``track_c``,
  ``frames`` and ``out_channels``.  A miss captures anew, and graphs over
  another store or key are dropped.  A command changes values only, so
  the bursts after it replay the same graph.
* Outputs: the blocks stay in the graph's pool for the caller's one
  fetch; ``v_active``, ``v_pos`` and ``clock`` are cloned out of it, so no
  state handed out aliases memory that a later replay rewrites.

Counters (``utils/trace.TRACE``): ``engine.graph_capture``, one a capture,
and ``engine.graph_replay``, one a replay with the blocks it rendered as
items.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.trace import TRACE
from .render import _jitter_seed, render_chain
from .state import EngineArrays

#: the fields every replay reads in place: no command replaces them
IN_PLACE = ("tracks", "rng_key")
#: the tensor fields copied into the graph's static inputs before a replay
COPIED = tuple(f.name for f in dataclasses.fields(EngineArrays)
               if f.name not in IN_PLACE and f.name != "track_c")

#: an integer dtype of each element size, to copy a tensor as its bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def copy_bits(dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
    """``d.copy_(s)`` for each pair of equal shape and dtype, as raw bits:
    one ``torch._foreach_copy_`` per element size, so float32, int32 and
    bool fields go in two launches."""
    groups: dict[int, tuple[list, list]] = {}
    for d, s in zip(dst, src, strict=True):
        bits = _BITS[d.element_size()]
        ds, ss = groups.setdefault(d.element_size(), ([], []))
        ds.append(d.view(bits))
        ss.append(s.view(bits))
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class _Graph:
    """``render_chain`` at one depth, captured over static inputs."""

    def __init__(self, st: EngineArrays, *, frames: int, out_channels: int,
                 depth: int):
        self.depth = depth
        self.static = [getattr(st, name).clone() for name in COPIED]
        static_st = dataclasses.replace(st, **dict(zip(COPIED, self.static)))
        # the graph reads these by address: they live as long as it does
        self.held = (st.tracks, st.rng_key, _jitter_seed(st.rng_key))

        def run():
            return render_chain(static_st, frames=frames,
                                out_channels=out_channels, depth=depth)

        with torch.cuda.device(st.device):
            # torch's recipe: one eager run on a side stream, then capture
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                run()
            stream.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = run()

    def __call__(self, st: EngineArrays) -> tuple[torch.Tensor, ...]:
        """The chain from ``st``: ``(blocks, v_active, v_pos, clock)`` as
        ``render_chain`` returns them, the blocks in the graph's pool."""
        copy_bits(self.static, [getattr(st, name) for name in COPIED])
        self.graph.replay()
        TRACE.count("engine.graph_replay", self.depth)
        blocks, act, pos, clock = self.out
        return blocks, act.clone(), pos.clone(), clock.clone()


class GraphedChain:
    """``render_chain`` on a CUDA state as one graph replay per burst, a
    graph captured for each burst shape on its first use."""

    def __init__(self):
        self._graphs: dict[tuple, _Graph] = {}

    def get(self, st: EngineArrays, *, frames: int, out_channels: int,
            depth: int) -> _Graph:
        """The graph of a burst from ``st``, captured on a miss.  Call it
        outside any span that records CUDA events, then call the graph."""
        fields = tuple((tuple(t.shape), t.dtype)
                       for t in (getattr(st, name) for name in COPIED))
        owner = (id(st.tracks), id(st.rng_key))
        key = (depth, frames, out_channels, st.track_c, owner, fields)
        graph = self._graphs.get(key)
        if graph is None:
            if any(k[4] != owner for k in self._graphs):
                self._graphs.clear()  # another store: free its graphs
            graph = _Graph(st, frames=frames, out_channels=out_channels,
                           depth=depth)
            self._graphs[key] = graph
            TRACE.count("engine.graph_capture")
        return graph
