"""Host syncs per decode call: the program's ``sync`` counter (blocking
host-to-device copies and device-to-host fetches) over its calls of
decode_assets in this process."""

from h100bench import program


def read(run):
    return program.per_call("sync", "calls")
