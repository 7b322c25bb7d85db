"""K1 (csrc/mp3_entropy.cu): the least time of the stretch's entropy
decodes (h100bench.roofline.k1_seconds) over K1's device time, in %."""

from h100bench import roofline


def read(run):
    tr = run.trace
    t = tr.kernel_s(lambda n: "mp3_entropy_kernel" in n) if tr else 0.0
    if t <= 0:
        return None
    least = sum(roofline.k1_seconds(run.inputs.blobs[i]) for files in tr.files for i in files)
    return 100.0 * least / t
