"""PCM encoders — the export half of the framework's IO surface.

The reference is decode-only (its ``AudioFile`` is a terminal sink,
decode_helpers.rs:17-38, and nothing in the tree writes audio back
out); this module is a beyond-reference addition so a user can round-trip:
decode/render on the card, then write WAV / AIFF / AU / CAF containers
that any tool — including our own decoders — reads back.  The bytes are
those of the JAX package's writers, dither included.  ``.flac`` goes
through ``codecs.flac.encode.encode_flac``.

Split of labor mirrors the decode direction in reverse:

  * ``pack_pcm`` — the compute (quantize, two's-complement byte split,
    endian order) runs as plain torch ops on the PCM's device over the
    whole [S, C] block: f32 PCM in, flat interleaved sample bytes out.  This is the
    exact inverse of ``ops.unpack.unpack_pcm`` (scale 2^(bits-1),
    wav.rs:143-154 / aiff.rs:159-170 semantics) so integer PCM
    round-trips bit-exactly through decode → encode → decode.
  * the container writers — pure host byte-splicing of headers around
    the fetched payload (chunk walks in reverse: RIFF/fmt/data,
    FORM/COMM/SSND with the IEEE-80 rate, ``.snd``).

Rounding: quantization uses round-half-to-even (``torch.round``).  Any
value a decoder produced is an exact multiple of 1/2^(bits-1), so the
tie rule never fires on round-trips; it only shapes fresh synthesis.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..utils import threefry

__all__ = [
    "pack_pcm", "encode_wav", "encode_aiff", "encode_au", "encode_caf",
    "write_audio", "export_batch",
]


def pack_pcm(
    pcm: torch.Tensor,  # f32 [S, C]
    *,
    bits: int,
    big_endian: bool = False,
    unsigned8: bool = False,
    is_float: bool = False,
    dither: int | None = None,
) -> torch.Tensor:
    """Quantize + interleave + byte-split f32 PCM → u8 [S*C*bits//8], on
    the PCM's device.

    Inverse of ``ops.unpack.unpack_pcm`` for the same config: integers
    scale by 2^(bits-1) with clipping to the signed range (the engine's
    mix path already clamps, but fresh synthesis may not), float32 is a
    bitcast.

    dither: optional integer seed enabling TPDF dither (±1 LSB
    triangular) added before the rounder — the standard mastering step
    when truncating synthesis/float content to integer PCM.  The noise is
    ``jax.random.uniform(PRNGKey(dither), (2, N))`` drawn bit for bit by
    ``utils/threefry``.  None (default) keeps the quantizer exact so
    decoded integers round-trip bit-exactly.
    """
    flat = pcm.reshape(-1)  # interleaved, frame-major (wav.rs:143-154)
    if is_float:
        if bits != 32:
            raise ValueError("float encode supports 32-bit only")
        word = flat.to(torch.float32).view(torch.int32).long() & threefry.M32
    else:
        if bits not in (8, 16, 24, 32):
            raise ValueError(f"unsupported bit depth {bits}")
        scale = float(1 << (bits - 1))
        hi = (1 << (bits - 1)) - 1
        # f32 cannot represent 2^31-1: clip in float at the largest
        # representable value <= hi, then again in integer space
        fmax = float(np.nextafter(np.float32(hi), np.float32(0))) \
            if bits == 32 else float(hi)
        x = flat * scale
        if dither is not None:
            u = threefry.uniform(threefry.prng_key(dither, device=flat.device),
                                 (2,) + tuple(flat.shape))
            x = x + (u[0] - u[1])  # TPDF in (-1, 1) LSB
        q = torch.clamp(torch.round(x), -scale, fmax)
        q = torch.nan_to_num(q, nan=0.0)  # f32 → int32 as XLA converts NaN
        ival = torch.clamp(q.to(torch.int64), -(1 << (bits - 1)), hi)
        if unsigned8:
            if bits != 8:
                raise ValueError("unsigned PCM is 8-bit only")
            ival = ival + 128
        word = ival & threefry.M32
    shifts = range(0, bits, 8)  # LE byte order...
    order = tuple(reversed(tuple(shifts))) if big_endian else tuple(shifts)
    by = [(word >> s) & 0xFF for s in order]
    return torch.stack(by, dim=-1).reshape(-1).to(torch.uint8)


def _payload(pcm, *, bits, big_endian=False, unsigned8=False,
             is_float=False, dither=None, device="cuda") -> bytes:
    from ..codecs.registry import resolve_device

    x = torch.as_tensor(np.asarray(pcm, np.float32), device=resolve_device(device))
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"pcm must be [frames, channels], got {tuple(x.shape)}")
    out = pack_pcm(
        x, bits=bits, big_endian=big_endian, unsigned8=unsigned8,
        is_float=is_float, dither=dither,
    )
    return out.cpu().numpy().tobytes()


def encode_wav(
    pcm, sample_rate: int, *, bits: int = 16, float_: bool = False,
    dither: int | None = None, rf64: bool = False, device="cuda",
) -> bytes:
    """Little-endian RIFF/WAVE bytes (the chunk layout ``codecs.wav``
    walks, wav.rs:80-141, written in reverse).  bits: 8 (unsigned,
    per convention) / 16 / 24 / 32 PCM, or 32 with ``float_`` for
    IEEE-float format code 3 (with the spec's fact chunk).

    rf64: write the EBU/ITU 64-bit RIFF form instead — ``RF64`` magic,
    the real sizes in a leading ``ds64`` chunk, and the 0xFFFFFFFF
    sentinel in the riff/data size fields.  Mandatory once the payload
    exceeds 4 GB; valid (and decoded by ``codecs.wav``) at any size."""
    if float_ and bits != 32:
        raise ValueError("float WAV encode is 32-bit")
    data = _payload(pcm, bits=bits, unsigned8=(bits == 8), is_float=float_,
                    dither=None if float_ else dither, device=device)
    ch = 1 if np.ndim(pcm) == 1 else int(np.shape(pcm)[1])
    frames = int(np.shape(pcm)[0])
    block = ch * bits // 8
    fmt = struct.pack(
        "<HHIIHH", 3 if float_ else 1, ch, int(sample_rate),
        int(sample_rate) * block, block, bits,
    )
    sentinel = 0xFFFFFFFF
    chunks = b""
    if rf64:
        # riffSize u64, dataSize u64, sampleCount u64, 0 table entries
        ds64_at = len(chunks)  # patched below once riff size is known
        chunks += b"ds64" + struct.pack("<I", 28) + struct.pack(
            "<QQQI", 0, len(data), frames, 0)
    chunks += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if float_:
        chunks += b"fact" + struct.pack("<II", 4, frames)
    chunks += b"data" + struct.pack(
        "<I", sentinel if rf64 else len(data)) + data
    if len(data) & 1:
        chunks += b"\x00"  # RIFF chunks are word-aligned
    if not rf64:
        return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
    riff_size = 4 + len(chunks)  # the u64 truth the sentinel points to
    chunks = (chunks[: ds64_at + 8]
              + struct.pack("<Q", riff_size)
              + chunks[ds64_at + 16 :])
    return b"RF64" + struct.pack("<I", sentinel) + b"WAVE" + chunks


def _ieee80(rate: float) -> bytes:
    """Encode a sample rate as IEEE 754 80-bit extended — the exact
    inverse of the decode semantics in aiff.rs:51-94 (value =
    mantissa · 2^(exponent-16383-63)).  Integer rates encode exactly."""
    if not rate > 0:
        raise ValueError(f"sample rate {rate} must be positive")
    if float(rate).is_integer():
        r = int(rate)
        e = r.bit_length() - 1
        mant = r << (63 - e)
    else:
        import math

        m, ex = math.frexp(float(rate))  # rate = m·2^ex, m in [0.5, 1)
        e = ex - 1
        mant = int(m * (1 << 64))
    return struct.pack(">HQ", 16383 + e, mant)


def encode_aiff(
    pcm, sample_rate: int, *, bits: int = 16, float_: bool = False,
    dither: int | None = None, device="cuda",
) -> bytes:
    """Big-endian FORM/AIFF bytes (COMM with the IEEE-80 rate + SSND,
    the walk of aiff.rs:99-183 in reverse).  bits: 8 (signed) / 16 /
    24 / 32 twos-complement PCM."""
    if float_:
        raise ValueError("float AIFF encode not supported (use wav/au)")
    data = _payload(pcm, bits=bits, big_endian=True, dither=dither,
                    device=device)
    ch = 1 if np.ndim(pcm) == 1 else int(np.shape(pcm)[1])
    frames = int(np.shape(pcm)[0])
    comm = struct.pack(">hLh", ch, frames, bits) + _ieee80(sample_rate)
    assert len(comm) == 18  # the comm_size the reference requires (:122-126)
    ssnd = struct.pack(">LL", 0, 0) + data  # offset 0, blockSize 0
    body = (
        b"AIFF"
        + b"COMM" + struct.pack(">L", len(comm)) + comm
        + b"SSND" + struct.pack(">L", len(ssnd)) + ssnd
        + (b"\x00" if len(ssnd) & 1 else b"")
    )
    return b"FORM" + struct.pack(">L", len(body)) + body


def encode_caf(
    pcm, sample_rate: int, *, bits: int = 16, float_: bool = False,
    little: bool = False, dither: int | None = None, device="cuda",
) -> bytes:
    """Apple CAF bytes (the int64-size chunk walk ``codecs.caf``
    parses, in reverse): 'caff' header, 32-byte 'desc' (big-endian f64
    rate + 'lpcm' + format flags + packet geometry), 'data' with the
    u32 edit count.  lpcm flags: bit0 float, bit1 little-endian."""
    if float_ and bits != 32:
        raise ValueError("float CAF encode is 32-bit")
    data = _payload(pcm, bits=bits, big_endian=not little, is_float=float_,
                    dither=None if float_ else dither, device=device)
    ch = 1 if np.ndim(pcm) == 1 else int(np.shape(pcm)[1])
    flags = (1 if float_ else 0) | (2 if little else 0)
    desc = struct.pack(
        ">d4sIIIII", float(sample_rate), b"lpcm", flags,
        ch * bits // 8, 1, ch, bits,
    )
    body = struct.pack(">I", 0) + data  # edit count 0 + audio bytes
    return (b"caff" + struct.pack(">HH", 1, 0)
            + b"desc" + struct.pack(">q", len(desc)) + desc
            + b"data" + struct.pack(">q", len(body)) + body)


# .snd encoding codes (codecs/au.py reads the same table)
_AU_CODES = {8: 2, 16: 3, 24: 4, 32: 5}


def encode_au(
    pcm, sample_rate: int, *, bits: int = 16, float_: bool = False,
    dither: int | None = None, device="cuda",
) -> bytes:
    """Sun AU / NeXT ``.snd`` bytes: fixed 24-byte big-endian header +
    big-endian payload (the layout ``codecs.au`` parses)."""
    if float_ and bits != 32:
        raise ValueError("float AU encode is 32-bit")
    data = _payload(pcm, bits=bits, big_endian=True, is_float=float_,
                    dither=None if float_ else dither, device=device)
    ch = 1 if np.ndim(pcm) == 1 else int(np.shape(pcm)[1])
    enc = 6 if float_ else _AU_CODES[bits]
    hdr = struct.pack(
        ">4sIIIII", b".snd", 24, len(data), enc, int(sample_rate), ch,
    )
    return hdr + data


def _encode_flac(pcm, sample_rate, **kw):
    # late import: the FLAC family is optional at io-module import time
    from ..codecs.flac.encode import encode_flac

    return encode_flac(pcm, sample_rate, **kw)


_WRITERS = {
    "wav": encode_wav, "aif": encode_aiff, "aiff": encode_aiff,
    "au": encode_au, "snd": encode_au, "caf": encode_caf,
    "flac": _encode_flac,
}

#: containers with a 32-bit IEEE-float form (FLAC is integer-only by
#: spec; AIFF float would be AIFC fl32, which the writer doesn't emit)
#: — callers validate against this instead of catching the writers'
#: errors
FLOAT_CONTAINERS = frozenset({"wav", "au", "snd", "caf"})


def export_batch(
    out_dir: str,
    batch,
    names: dict[str, int] | None = None,
    *,
    container: str = "wav",
    **kw,
) -> dict[str, str]:
    """Write every successfully-decoded file of an ``AudioBatch`` to
    ``out_dir/<name>.<container>`` — the inverse of
    ``codecs.registry.decode_dir``.  ``names`` is decode_dir's
    name→index map (defaults to ``f{i}``).  Each file keeps its own
    sample rate and trimmed length.  Returns name→path for the files
    written; errored files are skipped (their error codes stay the
    caller's to inspect, mirroring decode's skip-with-code policy)."""
    import os

    if container not in _WRITERS:
        raise ValueError(
            f"no encoder for container {container!r} (have {sorted(_WRITERS)})"
        )
    if names is None:
        names = {f"f{i}": i for i in range(batch.batch_size)}
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for name, i in sorted(names.items()):
        f = batch.file(i)
        if f.err:
            continue
        path = os.path.join(out_dir, f"{name}.{container}")
        with open(path, "wb") as fh:
            fh.write(_WRITERS[container](f.pcm, int(f.sample_rate), **kw))
        written[name] = path
    return written


def write_audio(path: str, pcm, sample_rate: int, **kw) -> None:
    """Write PCM to ``path``, container chosen by extension
    (.wav / .aif / .aiff / .au / .snd / .caf / .flac)."""
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    writer = _WRITERS.get(ext)
    if writer is None:
        raise ValueError(
            f"no encoder for extension {ext!r} (have {sorted(_WRITERS)})"
        )
    with open(path, "wb") as f:
        f.write(writer(pcm, sample_rate, **kw))
