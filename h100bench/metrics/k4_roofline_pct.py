"""K4 (csrc/window_add2.cu: window_add2_runmax, _plan, _main): the least
time of the stretch's FLAC value assemblies (h100bench.roofline.k4_seconds
over the files' samples) over K4's device time, in %."""

from h100bench import roofline


def read(run):
    tr = run.trace
    t = tr.kernel_s(lambda n: "window_add2_" in n) if tr else 0.0
    if t <= 0:
        return None
    samples = sum(run.inputs.frames(i) * run.inputs.channels for files in tr.files for i in files)
    return 100.0 * roofline.k4_seconds(samples) / t
