"""Metric readers: ``<name>.py`` holds ``read(run) -> float | None``.

``run`` carries the window's record (``setup_s``, ``wall_s``, ``calls``,
``audio_s``, ``latencies``), the traced stretch (``trace``, a
``h100bench.trace.Trace``, or None), the pool (``inputs``) and the
configuration.  A reader that finds nothing to read returns None and the
metric is left out of the line.  A metric named ``<stem>.<split>`` is read
by ``<stem>.py`` unless it has a file of its own.
"""
