"""The pool of files a configuration's maker makes, kept in the checkout.

Making a pool is the slow part of set-up (thousands of utterances, or
dozens of 30 s clips, encoded by NumPy writers), so the first run in a
checkout makes it, in pieces in worker processes, and writes it to
``.h100bench_cache/pools/<config>-<key>/``; later runs read it back.  The
path is fixed: ``key`` hashes the configuration and the sources of
``inputs/`` and of the tables the writers share with the references.  The
pool does not depend on ``--seed``: the seed draws each call's files from
it (``traffic.py``), as a loader's shuffle does.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import importlib
import json
import multiprocessing
import os
import shutil

from .inputs import Inputs

HERE = os.path.dirname(os.path.abspath(__file__))
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def key(config: dict) -> str:
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    sources = [os.path.join(HERE, "reference", "mp3_tables.py")]
    inputs = os.path.join(HERE, "inputs")
    sources += sorted(os.path.join(inputs, n) for n in os.listdir(inputs) if n.endswith(".py"))
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _call(task):
    module, fn, args = task
    return getattr(importlib.import_module(module), fn)(*args)


def parallel(tasks: list[tuple[str, str, tuple]], workers: int) -> list:
    """``module.fn(*args)`` of each task, in ``workers`` processes at a time
    (in this process where ``workers`` is 1), each with one BLAS thread."""
    if workers <= 1 or len(tasks) <= 1:
        return [_call(t) for t in tasks]
    saved = {v: os.environ.get(v) for v in _THREAD_VARS}
    os.environ.update({v: "1" for v in _THREAD_VARS})
    try:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(workers, len(tasks)),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(_call, tasks))
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


def build(config: dict, workers: int) -> list[tuple[bytes, dict]]:
    """Every file of the pool, made in pieces of the maker's ``CHUNK``."""
    module = f"h100bench.inputs.{config['maker']}"
    chunk = importlib.import_module(module).CHUNK
    n = int(config["pool_files"])
    tasks = [(module, "make_files", (config, list(range(a, min(n, a + chunk)))))
             for a in range(0, n, chunk)]
    return [f for part in parallel(tasks, workers) for f in part]


def load(config: dict, cache_root: str, workers: int) -> tuple[Inputs, bool]:
    """(the pool, whether this call made it)."""
    maker = importlib.import_module(f"h100bench.inputs.{config['maker']}")
    where = os.path.join(cache_root, "pools", f"{config['name']}-{key(config)}")
    made = not os.path.exists(os.path.join(where, "index.json"))
    if made:
        files = build(config, workers)
        tmp = f"{where}.part{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "blobs.bin"), "wb") as f:
            for blob, _ in files:
                f.write(blob)
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump({"sizes": [len(b) for b, _ in files], "info": [i for _, i in files]}, f)
        try:
            os.replace(tmp, where)
        except OSError:  # another run wrote it first
            shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(where, "index.json")) as f:
        index = json.load(f)
    with open(os.path.join(where, "blobs.bin"), "rb") as f:
        data = f.read()
    blobs, at = [], 0
    for size in index["sizes"]:
        blobs.append(data[at:at + size])
        at += size
    n = len(blobs)
    return Inputs(names=[f"{config['name']}-{i:05d}" for i in range(n)], ext=maker.EXT,
                  blobs=blobs, info=index["info"], sample_rate=int(config["sample_rate"]),
                  channels=int(config["channels"])), made
