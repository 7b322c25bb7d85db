"""Extension-dispatched batch decoding.

  1. partition assets by codec family (extension dispatch through
     models.MODELS);
  2. per family, pack all files into one ``[B, N]`` uint8 tensor on the
     device and run the family's vectorized header parser once;
  3. group files by static unpack config and unpack each group at once;
  4. reassemble a single ``AudioBatch`` in the original asset order.

Per-file failures never raise mid-batch: they surface as per-file error
codes (``AudioBatch.err``).  A file of a family the JAX package decodes
but this port does not yet raises ``NotImplementedError``; a truly
unknown extension gets ``ERR_UNSUPPORTED``.

The device is explicit: every entry point takes ``device=`` and nothing
falls back to the CPU; ``device="cuda"`` without a card raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import errors as E
from ..core.batch import AudioBatch, concat_batches
from ..io.assets import Asset, load_assets, pack_bytes, scan_assets
from ..ops.unpack import unpack_pcm
from ..utils.trace import TRACE
from . import wav as wav_codec

ADPCM_TODO = ("WAV ADPCM decode (IMA, MS) is not ported yet "
              "(ROADMAP queue 1, slice 2: ADPCM unpackers)")

# family name → (vectorized header parser, unpack-config fn, big_endian)
_PARSERS = {
    "wav": (wav_codec.parse_meta_batch, wav_codec.unpack_args, False),
}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def _bucket_frames(n: int, minimum: int = 256) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def _error_batch(names, formats, codes, device) -> AudioBatch:
    n = len(names)

    def z():
        return torch.zeros((n,), dtype=torch.int32, device=device)

    return AudioBatch(
        data=torch.zeros((n, 1), dtype=torch.float32, device=device),
        sample_rate=z(),
        num_channels=z(),
        bits_per_sample=z(),
        valid_frames=z(),
        err=torch.as_tensor(np.asarray(codes, np.int32), device=device),
        names=tuple(names),
        formats=tuple(formats),
    )


def decode_pcm_family(
    family: str, assets: list[Asset], *, device
) -> list[tuple[list[int], AudioBatch]]:
    """Decode one WAV family batch.

    Returns ``(family_local_indices, group_batch)`` pieces: one piece per
    static unpack config (bits/channels/float/companding) plus one piece
    for files whose header parse failed."""
    parse_meta, unpack_args_fn, big_endian = _PARSERS[family]
    bufs_np, lens_np = pack_bytes([a.data for a in assets])
    bufs = torch.as_tensor(bufs_np, device=device)
    meta = parse_meta(bufs, torch.as_tensor(lens_np, device=device))
    meta_host = {k: v.cpu().numpy() for k, v in meta.items()}

    groups: dict[tuple, list[int]] = {}
    failed: list[int] = []
    for i in range(len(assets)):
        if meta_host["err"][i] != E.ERR_OK:
            failed.append(i)
            continue
        row = {k: v[i] for k, v in meta_host.items()}
        cfg = unpack_args_fn(row)
        if cfg.get("adpcm") is not None:
            raise NotImplementedError(f"{assets[i].path}: {ADPCM_TODO}")
        key = (cfg["bits"], int(row["channels"]), cfg["is_float"],
               cfg["unsigned8"], cfg.get("companded"),
               cfg.get("big_endian", big_endian))
        groups.setdefault(key, []).append(i)

    pieces: list[tuple[list[int], AudioBatch]] = []
    if failed:
        pieces.append(
            (
                failed,
                _error_batch(
                    [assets[i].name for i in failed],
                    [family] * len(failed),
                    [int(meta_host["err"][i]) for i in failed],
                    device,
                ),
            )
        )

    for (bits, channels, is_float, unsigned8, companded, be), idxs in groups.items():
        sel_np = np.asarray(idxs, np.int64)
        sel = torch.as_tensor(sel_np, device=device)
        max_frames = _bucket_frames(int(meta_host["n_frames"][sel_np].max()))
        pcm = unpack_pcm(
            bufs[sel],
            meta["data_off"][sel],
            meta["n_frames"][sel],
            bits=bits,
            channels=channels,
            big_endian=be,
            unsigned8=unsigned8,
            is_float=is_float,
            companded=companded,
            max_frames=max_frames,
        )
        batch = AudioBatch(
            data=pcm, channels=channels,
            sample_rate=meta["sample_rate"][sel],
            num_channels=meta["channels"][sel],
            bits_per_sample=meta["bits"][sel],
            valid_frames=meta["n_frames"][sel],
            err=torch.zeros((len(idxs),), dtype=torch.int32, device=device),
            names=tuple(assets[i].name for i in idxs),
            formats=(family,) * len(idxs),
        )
        pieces.append((idxs, batch))

    return pieces


def decode_assets(assets: Sequence[Asset], *, device="cuda") -> AudioBatch:
    """Decode a mixed list of assets into one ``AudioBatch`` (asset order)
    on ``device``.  Routing goes through the model registry
    (models.MODELS)."""
    from .. import models  # late: models binds this module's family fns

    dev = resolve_device(device)
    assets = list(assets)
    by_family: dict[str, list[int]] = {}
    unknown: list[int] = []
    for i, a in enumerate(assets):
        m = models.for_extension(a.ext)
        if m is None:
            unknown.append(i)  # "unsupported format" skip
        else:
            by_family.setdefault(m.name, []).append(i)

    pieces: list[tuple[list[int], AudioBatch]] = []
    if unknown:
        pieces.append(
            (
                unknown,
                _error_batch(
                    [assets[i].name for i in unknown],
                    [assets[i].ext for i in unknown],
                    [E.ERR_UNSUPPORTED] * len(unknown),
                    dev,
                ),
            )
        )

    for fam, idxs in by_family.items():
        fam_assets = [assets[i] for i in idxs]
        with TRACE.stage(f"decode/{fam}"):
            fam_pieces = list(models.MODELS[fam].decode_group(fam_assets,
                                                              device=dev))
        for local_idxs, batch in fam_pieces:
            # decoded audio-seconds counter
            rate = np.maximum(batch.sample_rate.cpu().numpy(), 1)
            TRACE.add(
                f"decode/{fam}",
                float((batch.valid_frames.cpu().numpy() / rate).sum()),
            )
            pieces.append(([idxs[j] for j in local_idxs], batch))

    if not pieces:
        return _error_batch([], [], [], dev)

    order = np.concatenate([np.asarray(ix, np.int64) for ix, _ in pieces])
    merged = concat_batches([b for _, b in pieces])
    host_perm = np.argsort(order)
    perm = torch.as_tensor(host_perm, device=dev)
    return AudioBatch(
        data=merged.data[perm], channels=merged.channels,
        sample_rate=merged.sample_rate[perm],
        num_channels=merged.num_channels[perm],
        bits_per_sample=merged.bits_per_sample[perm],
        valid_frames=merged.valid_frames[perm],
        err=merged.err[perm],
        names=tuple(merged.names[i] for i in host_perm),
        formats=tuple(merged.formats[i] for i in host_perm),
    )


def decode_paths(paths: Sequence[str], *, device="cuda") -> AudioBatch:
    return decode_assets(load_assets(paths), device=device)


def decode_dir(asset_dir: str, *, device="cuda") -> tuple[AudioBatch, dict[str, int]]:
    """Scan + decode an asset folder on ``device``.

    Duplicate file stems are rejected after the first occurrence; returns
    the batch plus a name→batch-index map of the accepted tracks."""
    assets = load_assets(scan_assets(asset_dir))
    seen: dict[str, int] = {}
    kept: list[Asset] = []
    for a in assets:
        if a.name in seen:
            continue  # "multiple files with the same name" skip
        seen[a.name] = len(kept)
        kept.append(a)
    return decode_assets(kept, device=device), seen
