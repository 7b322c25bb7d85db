"""Input makers: ``inputs/<maker>.py`` makes a configuration's pool of files.

A configuration's file names its maker.  A maker holds ``EXT`` (the files'
extension), ``CHUNK`` (files per task of the pool's build) and
``make_files(config, indices)``, which returns each file's bytes and
``info`` (``frames``: its valid frames; anything else the traffic or a
metric reads, such as ``frame_offsets``).  File ``i`` depends on the
configuration and ``i`` alone, so the pool can be made in pieces and kept
(``h100bench/pool.py``).  A maker whose files encode known samples also
holds ``truth(config, i)``, file i's source samples.  Makers import nothing
of the program under test, so that later changes to it cannot move the
inputs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Inputs:
    """A pool of files as a loader holds them in host memory."""

    names: list[str]
    ext: str
    blobs: list[bytes]
    info: list[dict]
    sample_rate: int
    channels: int

    def frames(self, i: int) -> int:
        return int(self.info[i]["frames"])
