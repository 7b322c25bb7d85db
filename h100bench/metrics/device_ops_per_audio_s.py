"""Device events (kernels, copies, memsets) in the traced stretch per
audio-second it decoded: the host's dispatch work per unit of audio."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.audio_s <= 0:
        return None
    return len(tr.device) / tr.audio_s
