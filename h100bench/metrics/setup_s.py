"""Set-up seconds: imports, CUDA start, the program's libraries, the pool
of files and the warm-up calls (host clock)."""


def read(run):
    return run.setup_s
