"""Share of the traced stretch in which no device event (kernel, copy,
memset) ran: 100 × (1 − union of the device events' intervals / stretch),
averaged over the cell's cards (``Trace.busy_s`` is the cards' mean)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
