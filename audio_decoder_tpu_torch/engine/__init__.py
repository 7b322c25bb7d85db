"""Render engine on torch tensors (voices, groups, tempo, sequencers)."""
from .state import EngineArrays, HostRegistry, empty_state, tracks_from_batch
from .render import render_block, render_chain, render_seconds
from .commands import CmdErr, CmdProcessor, Command, apply

__all__ = [
    "EngineArrays", "HostRegistry", "empty_state", "tracks_from_batch",
    "render_block", "render_chain", "render_seconds", "CmdErr",
    "CmdProcessor", "Command", "apply",
]
