"""K3 (csrc/window_add.cu: window_add_runmax, _plan, _main): the least time
of the stretch's FLAC PCM assemblies (h100bench.roofline.k3_seconds over
the files' samples) over K3's device time, in %."""

from h100bench import roofline

KERNELS = ("window_add_main", "window_add_runmax", "window_add_plan")


def read(run):
    tr = run.trace
    t = tr.kernel_s(lambda n: any(k in n for k in KERNELS)) if tr else 0.0
    if t <= 0:
        return None
    samples = sum(run.inputs.frames(i) * run.inputs.channels for files in tr.files for i in files)
    return 100.0 * roofline.k3_seconds(samples) / t
