"""Audio-seconds of every file decoded in the window (valid frames over
the sample rate, files without an error code) over the window's wall time
(host clock)."""


def read(run):
    return run.audio_s / run.wall_s
