"""The host side of ``engine/graphed.py`` and the loop's choice of path, on
the CPU (the capture and the replays are held on the card by
``tests/test_torch_cuda.py``).

``copy_bits`` copies every copied field bit for bit in one foreach call per
element size; ``COPIED`` and ``IN_PLACE`` cover every tensor field once; a
``GraphedChain`` captures once per burst shape and store (a stand-in
records the captures), not after a command; and an ``EngineLoop`` off the
card keeps no graphs and counts no ``engine.graph_*``.
"""

import dataclasses

import numpy as np
import torch

from audio_decoder_tpu_torch.engine import commands as EC
from audio_decoder_tpu_torch.engine import graphed as G
from audio_decoder_tpu_torch.engine import state as ES
from audio_decoder_tpu_torch.runtime import loop as loop_mod
from audio_decoder_tpu_torch.runtime.native import Sink
from audio_decoder_tpu_torch.utils import trace


def _stat(name):
    s = trace.TRACE.stats.get(name)
    return (s.calls, s.items) if s is not None else (0, 0.0)


def _state():
    pcm = np.random.default_rng(0).uniform(-0.3, 0.3, (3, 4410, 2)).astype(np.float32)
    st = ES.empty_state(pcm, [4410, 3000, 2000], [2, 2, 1], out_channels=2, device="cpu")
    reg = ES.HostRegistry(["a", "b", "c"])
    proc = EC.CmdProcessor(reg, 44100)
    for line in ("load a -t s:300", "seq a -p 4 -s 0,1 -c a:0.5 -j a:0.3",
                 "load b", "velocity b -0.5", "start -v a", "start -v b"):
        st = EC.apply(st, reg, proc.parse(line))
    return st, reg, proc


def test_the_copied_and_in_place_fields_cover_every_tensor_field_once():
    assert set(G.COPIED).isdisjoint(G.IN_PLACE)
    assert sorted(G.COPIED + G.IN_PLACE) == sorted(ES.FIELD_DTYPES)


def test_copy_bits_copies_every_field_exactly_in_one_call_per_element_size(monkeypatch):
    st, _, _ = _state()
    src = [getattr(st, name) for name in G.COPIED]
    # float bits that a value copy could lose: a NaN payload, -0.0, inf
    odd = np.array([0x7FC01234, 0x80000000, 0x7F800000], np.uint32).view(np.float32)
    v_pos = st.v_pos.clone()
    v_pos[:3] = torch.from_numpy(odd)
    src[G.COPIED.index("v_pos")] = v_pos
    dst = [torch.empty_like(t) for t in src]
    calls = []
    real = torch._foreach_copy_

    def counting(ds, ss):
        calls.append({d.dtype for d in ds})
        return real(ds, ss)

    monkeypatch.setattr(torch, "_foreach_copy_", counting)
    G.copy_bits(dst, src)
    for d, s in zip(dst, src):
        assert d.dtype == s.dtype and d.shape == s.shape
        bits = G._BITS[s.element_size()]
        assert torch.equal(d.view(bits), s.view(bits))
    # float32 and int32 fields as int32 bits, bool fields as uint8
    assert sorted(calls, key=str) == [{torch.int32}, {torch.uint8}]


def test_a_graph_is_captured_once_per_burst_shape_and_store(monkeypatch):
    made = []

    class Stand:  # records a capture instead of making one
        def __init__(self, st, *, frames, out_channels, depth):
            made.append((depth, frames, st.tracks))

    monkeypatch.setattr(G, "_Graph", Stand)
    st, reg, proc = _state()
    chain = G.GraphedChain()
    captures = _stat("engine.graph_capture")[0]
    one = chain.get(st, frames=128, out_channels=2, depth=1)
    assert chain.get(st, frames=128, out_channels=2, depth=1) is one
    # a command replaces values, not shapes: the same graph
    st2 = EC.apply(st, reg, proc.parse("trem a -p 2 -d 0.5"))
    st2 = EC.apply(st2, reg, proc.parse("velocity a 1.5"))
    assert st2.p_kind is not st.p_kind and st2.v_vel is not st.v_vel
    assert chain.get(st2, frames=128, out_channels=2, depth=1) is one
    for depth in (2, 4, 8):
        chain.get(st2, frames=128, out_channels=2, depth=depth)
    chain.get(st2, frames=4096, out_channels=2, depth=8)
    assert [m[:2] for m in made] == [(1, 128), (2, 128), (4, 128), (8, 128), (8, 4096)]
    # another store: a new capture, and the old store's graphs dropped
    st3 = dataclasses.replace(st2, tracks=st2.tracks.clone())
    three = chain.get(st3, frames=128, out_channels=2, depth=1)
    assert three is not one and made[-1][2] is st3.tracks
    assert len(chain._graphs) == 1
    # another key tensor too
    st4 = dataclasses.replace(st3, rng_key=st3.rng_key.clone())
    assert chain.get(st4, frames=128, out_channels=2, depth=1) is not three
    assert _stat("engine.graph_capture")[0] - captures == len(made) == 7


def test_an_engine_loop_off_the_card_replays_no_graph(monkeypatch):
    monkeypatch.setattr(loop_mod, "SPEC_DEPTH", 8)
    st, reg, _ = _state()
    loop = loop_mod.EngineLoop(st, reg, 44100, 2, sink=Sink("default", 44100, 2, realtime=False))
    assert loop._graphs is None
    before = [_stat(n) for n in ("engine.graph_capture", "engine.graph_replay")]
    bursts = _stat("engine.burst")[1]
    loop.run_blocks(15)                        # bursts 1, 2, 4, 8
    assert loop.submit("velocity a 0.5")
    loop.run_blocks(3)
    assert not loop.errors
    assert _stat("engine.burst")[1] - bursts == 18
    assert [_stat(n) for n in ("engine.graph_capture", "engine.graph_replay")] == before
