"""Share of the blocks the live loop rendered that a CUDA graph replay
rendered: the program's ``engine.graph_replay`` items over its
``engine.burst`` items, in %.

Both counters are read from the program's tracer over the process (the
harness runs one cell per process, so the warm-up calls count too): the
window's records keep the change of only the counters the live program
names.  None where the program keeps no ``engine.graph_replay`` counter:
an earlier version, or a loop whose state is not on the card."""

from h100bench import program


def read(run):
    stats = getattr(program._tracer(), "stats", {})
    replayed, rendered = stats.get("engine.graph_replay"), stats.get("engine.burst")
    if replayed is None or rendered is None or not rendered.items:
        return None
    return 100.0 * replayed.items / rendered.items
