"""Double-buffered streaming decode over large asset sets, and chunked
decode of one long file.

When decoding more files than fit one batch, host work (file reads) for
chunk k+1 overlaps the decode of chunk k: a background thread reads files
while the caller consumes batches.  The per-chunk decode itself is
``codecs.registry.decode_assets`` on the consumer's thread, so the stream
yields the same ``AudioBatch`` objects as the one-shot API.

It is the port of the JAX package's ``io/stream.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from ..core.batch import AudioBatch
from .assets import load_assets


def stream_decode(
    paths: Sequence[str],
    files_per_batch: int = 16,
    prefetch: int = 2,
    *,
    device="cuda",
) -> Iterator[tuple[list[str], AudioBatch]]:
    """Decode paths in chunks on ``device``, reading files ahead in the
    background.

    Yields (chunk_paths, AudioBatch) in order.  `prefetch` bounds how many
    read chunks may queue ahead of the consumer (host memory bound).  An
    unreadable path re-raises its OSError when its chunk is reached."""
    from ..codecs.registry import decode_assets, resolve_device

    dev = resolve_device(device)
    chunks = [
        list(paths[i : i + files_per_batch])
        for i in range(0, len(paths), files_per_batch)
    ]
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def loader():
        try:
            for chunk in chunks:
                if stop.is_set():
                    return
                try:
                    assets = load_assets(chunk)
                except OSError as e:
                    q.put(("err", chunk, e))
                    continue
                q.put(("ok", chunk, assets))
        finally:
            q.put(("done", None, None))

    t = threading.Thread(target=loader, daemon=True)
    t.start()
    try:
        while True:
            kind, chunk, payload = q.get()
            if kind == "done":
                return
            if kind == "err":
                raise payload
            yield chunk, decode_assets(payload, device=dev)
    finally:
        stop.set()
        # unblock a loader waiting on a full queue so the thread ends
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


def stream_file(
    path: str, granules_per_chunk: int = 512, start_sample: int = 0,
    frames_per_chunk: int = 128, pcm_frames_per_chunk: int = 1 << 17,
    flac_frames_per_chunk: int = 64, *, device="cuda",
) -> Iterator[np.ndarray]:
    """Chunked decode of ONE long file on ``device``: yields float32
    [samples, channels] host chunks with bounded device memory; the
    concatenated output equals the one-shot decode.  `start_sample`
    seeks: output begins exactly at that sample of the one-shot decode.

    MPEG audio (any layer) rides codecs.mpeg.decoder.mpeg_stream (Layer
    III Mp3Stream, Layers I/II L12Stream); FLAC rides
    codecs.flac.stream.FlacStream (frames are independent, so fixed frame
    windows chunk exactly); WAV/AIFF/AU/CAF ride
    codecs.pcm_stream.PcmStream (the file is memory-mapped and unpacked in
    fixed frame windows, so host AND device memory stay O(chunk))."""
    from ..codecs.registry import resolve_device

    dev = resolve_device(device)
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("mp3", "mp2", "mp1"):
        from ..codecs.mpeg.decoder import mpeg_stream

        with open(path, "rb") as fh:
            data = fh.read()
        st = mpeg_stream(data, granules_per_chunk=granules_per_chunk,
                         frames_per_chunk=frames_per_chunk, device=dev)
        yield from st.chunks(start_sample=start_sample)
        return
    if ext == "flac":
        from ..codecs.flac.stream import FlacStream

        with open(path, "rb") as fh:
            data = fh.read()
        st = FlacStream(data, frames_per_chunk=flac_frames_per_chunk,
                        device=dev)
        yield from st.chunks(start_sample=start_sample)
        return
    from ..codecs.pcm_stream import PcmStream

    yield from PcmStream(path, frames_per_chunk=pcm_frames_per_chunk,
                         device=dev).chunks(start_sample=start_sample)


def decode_all(paths: Sequence[str], files_per_batch: int = 16, *,
               device="cuda") -> AudioBatch:
    """Stream-decode everything on ``device`` and concatenate into one
    AudioBatch."""
    from ..codecs.registry import resolve_device
    from ..core.batch import concat_batches

    dev = resolve_device(device)
    batches = [b for _, b in stream_decode(paths, files_per_batch,
                                           device=dev)]
    if not batches:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return AudioBatch(
            data=torch.zeros((0, 1), dtype=torch.float32, device=dev),
            sample_rate=z, num_channels=z, bits_per_sample=z,
            valid_frames=z, err=z,
        )
    return concat_batches(batches)
