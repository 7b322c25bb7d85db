"""Native runtime: command ring, playback sink, terminal, main loop."""
from .native import CmdRing, RawTerminal, Sink, available
from .loop import EngineLoop, repl, PERIOD

__all__ = ["CmdRing", "RawTerminal", "Sink", "available", "EngineLoop", "repl", "PERIOD"]
