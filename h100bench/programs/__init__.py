"""Programs under test: ``programs/<name>.py`` is what a cell's calls drive.

A configuration's file names its program under the key ``program``; one
that names none drives ``decode``.  The loop (``h100bench/run.py``) owns
set-up timing, the pool, the warm-up, the window, the profiler's stretch,
the seeded sample of kept outputs, the peak memory, the metric readers and
the result line; a program owns what a call is and what makes it right.
A program module holds:

* ``start(config, mix, inputs, seed, device, **hooks)``: the session, made
  in set-up (its time counts in ``setup_s``; it may run the program under
  test).  ``inputs`` is the pool the configuration's maker made; ``hooks``
  are what a test hands ``run_cell`` to break the program underneath.
  ``device`` is the cell's first card: ``"cuda"`` for a cell on one card,
  which gets nothing more.  A cell on more cards (``chips`` in
  ``BENCHMARK.json``) also gets the keyword ``cards``, the list of them
  all, ``"cuda:0"`` to ``"cuda:<chips-1>"``, whose first is ``device``; its
  program spreads its work over them, and its calls' fetches wait for
  every card's work.  The loop syncs every card after the warm-up, reads
  every card's peak memory and empties every card's cache before the
  references run;
* ``pieces(config, mix)``: the files (paths from the checkout's root) the
  cell needs besides the configuration, the mix, the maker and the
  readers; it raises ``KeyError`` or ``ValueError`` on a mix it cannot run.

A session holds:

* ``call(k)``: call k of the schedule, ending in a host fetch that waits
  for its device work; returns ``(record, output)``.  The record holds
  ``audio_s`` (the audio-seconds the call produced, which the loop sums
  into ``audio_s_per_s`` and the trace), ``files`` (the pool indices it
  used, which the roofline readers count; empty where it uses none) and
  whatever the judge needs.  The output is what the loop may keep for the
  comparison;
* ``to_host(record, output)``: a kept output as host arrays, after the
  window;
* ``close()``: frees the program's device state before the references run;
* ``judge(records, kept, workers)``: ``(checks {name: (value, limit)},
  failed calls)``, where ``kept[p]`` is ``to_host`` of the output of
  ``records[p]``; references may run in ``workers`` processes.
"""
