"""Chunked single-file WAV/AIFF/AU/CAF streaming decode with O(chunk)
memory.

The batch decoders (codecs.wav / aiff / au / caf) materialize whole files
on the device — right for throughput over many assets, wrong for ONE
multi-hour PCM file.  ``PcmStream`` memory-maps the file, parses the
header once on the host (the scalar walks below mirror the batched device
walks exactly; tests/test_torch_streams.py pins host-vs-device metadata
parity), then unpacks fixed-size frame windows through the SAME device
unpackers as the batch path (ops.unpack) — one chunk shape for any file
length, and output equal to the one-shot decode because PCM unpacking is
stateless per frame and ADPCM blocks are self-contained.

Seeking is free: ``chunks(start_sample=N)`` starts the byte window at
frame N (block codecs start at the enclosing block and trim its prefix).

It is the port of the JAX package's ``codecs/pcm_stream.py``; the byte
helpers and the four header parsers are verbatim copies (host scalar
walks, no JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import errors as E
from ..ops.unpack import (
    unpack_ima4,
    unpack_ima_adpcm,
    unpack_ms_adpcm,
    unpack_pcm,
)
from . import aiff as _aiff
from . import au as _au
from . import caf as _caf
from . import wav as _wav

_MAX_CHUNKS = 128  # same walk bound as the device parsers

_ADPCM = {"ima": unpack_ima_adpcm, "ms": unpack_ms_adpcm, "ima4": unpack_ima4}


def _u16le(b, p):
    return int.from_bytes(bytes(b[p : p + 2]), "little")


def _u32le(b, p):
    return int.from_bytes(bytes(b[p : p + 4]), "little")


def _u16be(b, p):
    return int.from_bytes(bytes(b[p : p + 2]), "big")


def _u32be(b, p):
    return int.from_bytes(bytes(b[p : p + 4]), "big")


def _tag(b, p):
    return bytes(b[p : p + 4])


def parse_wav_header(mm) -> dict:
    """Host mirror of codecs.wav._parse_one over a memmap/bytes buffer.

    Returns the same metadata fields as the device walk (META_FIELDS) or
    raises the DecodeError matching the device error code; semantics —
    unknown-chunk skip, word-aligned cursor, WAVEFORMATEXTENSIBLE
    SubFormat promotion, truncated-data EOF, supported-format matrix —
    are kept identical (pinned by tests/test_pcm_stream.py)."""
    flen = len(mm)
    magic = _tag(mm, 0) if flen >= 12 else b""
    is_64 = magic in (b"RF64", b"BW64")  # EBU/ITU 64-bit RIFF
    if flen < 12 or magic not in (b"RIFF", b"RF64", b"BW64") or (
            _tag(mm, 8) != b"WAVE"):
        raise E.UnsupportedFormatError("not a RIFF/WAVE file")
    cursor, it = 12, 0
    fmt_off = fmt_size = data_off = data_size = -1
    fact_val = 0
    ds64_data = ds64_count = 0  # true 64-bit sizes (host ints: exact)
    while cursor + 8 <= flen and it < _MAX_CHUNKS and data_off < 0:
        cid = _tag(mm, cursor)
        csize = _u32le(mm, cursor + 4)
        payload = cursor + 8
        if cid == b"fmt ":
            fmt_off, fmt_size = payload, csize
        elif cid == b"ds64" and csize >= 24:
            ds64_data = int.from_bytes(bytes(mm[payload + 8 : payload + 16]),
                                       "little")
            ds64_count = int.from_bytes(
                bytes(mm[payload + 16 : payload + 24]), "little")
        elif cid == b"fact" and csize >= 4:
            fact_val = _u32le(mm, payload)
        elif cid == b"data":
            if is_64 and csize == 0xFFFFFFFF:  # RF64 size sentinel
                csize = ds64_data
            if payload + csize > flen:
                raise E.UnexpectedEofError("truncated data chunk")
            data_off, data_size = payload, csize
        cursor = payload + csize + (csize & 1)
        it += 1
    if fact_val == 0 and is_64:
        fact_val = ds64_count  # ds64's sampleCount plays fact's role
    if fmt_off < 0 or data_off < 0:
        raise E.UnexpectedEofError("missing fmt/data chunk")
    p = fmt_off
    fmt_code = _u16le(mm, p)
    channels = _u16le(mm, p + 2)
    sample_rate = _u32le(mm, p + 4)
    block_align = _u16le(mm, p + 12)
    bits = _u16le(mm, p + 14)
    cb_size = _u16le(mm, p + 16) if fmt_size >= 18 else 0
    if fmt_code == _wav.FORMAT_EXTENSIBLE and cb_size >= 22:
        fmt_code = _u16le(mm, p + 24)
    supported = (
        (fmt_code == _wav.FORMAT_PCM and bits in (8, 16, 24, 32))
        or (fmt_code == _wav.FORMAT_IEEE_FLOAT and bits in (32, 64))
        or (fmt_code in (_wav.FORMAT_ALAW, _wav.FORMAT_MULAW) and bits == 8)
        or (fmt_code in (_wav.FORMAT_IMA_ADPCM, _wav.FORMAT_MS_ADPCM)
            and bits == 4)
    )
    if not supported:
        raise E.UnsupportedFormatError(
            f"WAV format code {fmt_code} at {bits}-bit")
    if channels <= 0 or bits == 0:
        raise E.InvalidDataError("bad channel count / sample size")
    if fmt_code in (_wav.FORMAT_IMA_ADPCM, _wav.FORMAT_MS_ADPCM):
        # same geometry rules + frame math as the device walk (a short
        # fmt without wSamplesPerBlock derives the count instead)
        spb_absent = fmt_size < 20
        spb_decl = _u16le(mm, p + 18)
        if fmt_code == _wav.FORMAT_IMA_ADPCM:
            w = (block_align - 4 * channels) // max(4 * channels, 1)
            spb = 1 + 8 * w
            ok = (block_align > 4 * channels
                  and block_align % max(4 * channels, 1) == 0
                  and (spb_absent or spb_decl == spb))
        else:
            spb = 2 + (block_align - 7 * channels) * 2 // max(channels, 1)
            ok = (block_align > 7 * channels and channels <= 2
                  and (spb_absent or spb_decl == spb))
        if not ok:
            raise E.InvalidDataError(
                f"bad ADPCM geometry (block_align {block_align})")
        full, rem = divmod(data_size, max(block_align, 1))
        if fmt_code == _wav.FORMAT_IMA_ADPCM:
            partial = (1 + ((rem - 4 * channels) // max(4 * channels, 1)) * 8
                       if rem >= 4 * channels else 0)
        else:
            partial = (2 + (rem - 7 * channels) * 2 // max(channels, 1)
                       if rem > 7 * channels else 0)
        n_frames = full * spb + partial
        if fact_val > 0:
            n_frames = min(n_frames, fact_val)
    else:
        n_frames = data_size // max(channels * (bits // 8), 1)
    return dict(
        fmt_code=fmt_code, channels=channels, sample_rate=sample_rate,
        bits=bits, data_off=data_off, data_size=data_size,
        n_frames=n_frames, block_align=block_align,
    )


def parse_aiff_header(mm) -> dict:
    """Host mirror of codecs.aiff._parse_one (FORM walk, AIFC compression
    types, SSND offset field, COMM-size validation)."""
    flen = len(mm)
    form_type = _tag(mm, 8) if flen >= 12 else b""
    is_aifc = form_type == b"AIFC"
    if flen < 12 or _tag(mm, 0) != b"FORM" or form_type not in (
            b"AIFF", b"AIFC"):
        raise E.UnsupportedFormatError("not a FORM/AIFF file")
    cursor, it = 12, 0
    comm_off = comm_size = ssnd_off = ssnd_size = -1
    while (cursor + 8 <= flen and it < _MAX_CHUNKS
           and (comm_off < 0 or ssnd_off < 0)):
        cid = _tag(mm, cursor)
        csize = _u32be(mm, cursor + 4)
        payload = cursor + 8
        if cid == b"COMM":
            comm_off, comm_size = payload, csize
            if (comm_size < 22) if is_aifc else (comm_size != 18):
                raise E.InvalidDataError(f"COMM size {comm_size}")
        elif cid == b"SSND":
            if payload + csize > flen:
                raise E.UnexpectedEofError("truncated SSND chunk")
            ssnd_off, ssnd_size = payload, csize
        cursor = payload + csize + (csize & 1)
        it += 1
    if comm_off < 0 or ssnd_off < 0:
        raise E.UnexpectedEofError("missing COMM/SSND chunk")
    p = comm_off
    channels = _u16be(mm, p)
    comm_frames = _u32be(mm, p + 2)
    bits = _u16be(mm, p + 6)
    # IEEE 754 80-bit extended sample rate (≙ ops.bytes.read_ieee_extended,
    # semantics of reference aiff.rs:51-94) — host integer decode
    se = _u16be(mm, p + 8)
    mant = int.from_bytes(bytes(mm[p + 10 : p + 18]), "big")
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        rate_f = 0.0
    elif exp == 0x7FFF:
        rate_f = float("nan")
    else:
        rate_f = mant * 2.0 ** (exp - 16383 - 63)
        if se & 0x8000:
            rate_f = -rate_f
    sample_rate = int(round(rate_f)) if rate_f == rate_f else 0
    q = ssnd_off
    offset = _u32be(mm, q)
    data_off = q + 8 + offset
    data_size = max(ssnd_size - 8 - offset, 0)
    comp = _tag(mm, p + 18) if is_aifc else b"NONE"
    little = comp == b"sowt"
    f32c = comp in (b"fl32", b"FL32")
    f64c = comp in (b"fl64", b"FL64")
    ulawc = comp in (b"ulaw", b"ULAW")
    alawc = comp in (b"alaw", b"ALAW")
    g711 = ulawc or alawc
    ima4 = comp == b"ima4"
    int_ok = bits in (8, 16, 24, 32) and (
        comp in (b"NONE", b"twos") or little)
    float_ok = (f32c and bits == 32) or (f64c and bits == 64)
    g711_ok = g711 and bits in (8, 16)
    if not (int_ok or float_ok or g711_ok or (ima4 and bits == 16)):
        raise E.UnsupportedFormatError(
            f"AIFC compression {comp!r} at {bits}-bit")
    if channels <= 0 or sample_rate <= 0:
        raise E.InvalidDataError("bad channel count / sample rate")
    bps = 1 if g711 else bits // 8  # companded: 1 stored byte/sample
    if ima4:  # whole 34·C-byte packet groups of 64 frames each
        n_frames = min(
            comm_frames, (data_size // max(34 * channels, 1)) * 64)
    else:
        n_frames = min(comm_frames, data_size // max(channels * bps, 1))
    fmt_code = (6 if ima4 else 5 if alawc else 4 if ulawc
                else 3 if f64c else (2 if f32c else int(little)))
    return dict(
        fmt_code=fmt_code, channels=channels, sample_rate=sample_rate,
        bits=bits, data_off=data_off, data_size=data_size, n_frames=n_frames,
    )


def parse_au_header(mm) -> dict:
    """Host mirror of codecs.au._parse_one (fixed big-endian header)."""
    flen = len(mm)
    if flen < 24 or _tag(mm, 0) != b".snd":
        raise E.UnsupportedFormatError("not a Sun AU / NeXT SND file")
    data_off = _u32be(mm, 4)
    data_size = _u32be(mm, 8)
    enc = _u32be(mm, 12)
    sample_rate = _u32be(mm, 16)
    channels = _u32be(mm, 20)
    if enc not in _au.ENCODINGS:
        raise E.UnsupportedFormatError(f"AU encoding {enc}")
    if channels <= 0 or sample_rate <= 0 or data_off < 24:
        raise E.InvalidDataError("bad AU header geometry")
    if data_off > flen:
        raise E.UnexpectedEofError("AU data offset past EOF")
    bits, _is_float, companded = _au.ENCODINGS[enc]
    avail = max(flen - data_off, 0)
    if data_size == 0xFFFFFFFF:  # unknown-size convention: read to EOF
        data_size = avail
    data_size = min(data_size, avail)
    bps = 1 if companded else bits // 8
    n_frames = data_size // max(channels * bps, 1)
    return dict(
        fmt_code=enc, channels=channels, sample_rate=sample_rate,
        bits=bits, data_off=data_off, data_size=data_size,
        n_frames=n_frames,
    )


def parse_caf_header(mm) -> dict:
    """Host mirror of codecs.caf._parse_one — with exact int64 chunk
    sizes, so true > 4 GB 'data' chunks (and the -1 to-EOF convention)
    stream correctly."""
    import struct as _st

    flen = len(mm)
    if flen < 8 or _tag(mm, 0) != b"caff" or _u16be(mm, 4) != 1:
        raise E.UnsupportedFormatError("not a CAF file")
    cursor, it = 8, 0
    desc_off = data_off = -1
    data_size = 0
    while cursor + 12 <= flen and it < _MAX_CHUNKS and data_off < 0:
        cid = _tag(mm, cursor)
        csize = int.from_bytes(bytes(mm[cursor + 4 : cursor + 12]),
                               "big", signed=True)
        payload = cursor + 12
        if csize == -1:  # "to EOF" (legal on the last chunk)
            csize = flen - payload
        if cid in (b"desc", b"data") and (csize < 0
                                          or payload + csize > flen):
            raise E.UnexpectedEofError(f"truncated {cid.decode()} chunk")
        if cid == b"desc":
            desc_off = payload
        elif cid == b"data":
            data_off = payload + 4  # past the u32 edit count
            data_size = max(csize - 4, 0)
        cursor = payload + csize
        it += 1
    if desc_off < 0 or data_off < 0:
        raise E.UnexpectedEofError("missing desc/data chunk")
    p = desc_off
    rate_f = _st.unpack(">d", bytes(mm[p : p + 8]))[0]
    # exact mirror of the device decode (_read_f64be_int): NaN/inf/
    # negative → 0 (rejected below), finite values rounded and clamped
    if rate_f != rate_f or rate_f in (float("inf"), float("-inf")):
        rate_f = 0.0
    sample_rate = int(round(min(max(rate_f, 0.0), float(2**31 - 128))))
    codec = _tag(mm, p + 8)
    flags = _u32be(mm, p + 12)
    bytes_pp = _u32be(mm, p + 16)
    frames_pp = _u32be(mm, p + 20)
    channels = _u32be(mm, p + 24)
    bits = _u32be(mm, p + 28)
    is_float = codec == b"lpcm" and bool(flags & _caf._FLAG_FLOAT)
    lpcm_ok = (codec == b"lpcm"
               and (bits in (32, 64) if is_float
                    else bits in (8, 16, 24, 32))
               and frames_pp == 1 and bytes_pp == channels * (bits // 8))
    g711 = codec in (b"ulaw", b"alaw")
    g711_ok = g711 and bytes_pp == channels and frames_pp == 1
    ima4_ok = (codec == b"ima4" and bytes_pp == 34 * channels
               and frames_pp == 64)
    if not (lpcm_ok or g711_ok or ima4_ok):
        raise E.UnsupportedFormatError(
            f"CAF codec {codec!r} ({bits}-bit, {bytes_pp}B/packet)")
    if channels <= 0 or sample_rate <= 0:
        raise E.InvalidDataError("bad CAF desc geometry")
    bps = 1 if g711 else bits // 8
    if codec == b"ima4":
        n_frames = (data_size // max(34 * channels, 1)) * 64
    else:
        n_frames = data_size // max(channels * bps, 1)
    fmt_code = (6 if codec == b"ima4" else 5 if codec == b"alaw"
                else 4 if codec == b"ulaw" else int(is_float))
    return dict(
        fmt_code=fmt_code, channels=channels, sample_rate=sample_rate,
        bits=bits, data_off=data_off, data_size=data_size,
        n_frames=n_frames, flags=flags,
    )


def container_for(src) -> str:
    """The container a path's extension, or a buffer's magic, names."""
    if isinstance(src, str):
        ext = src.rsplit(".", 1)[-1].lower()
        return ("aiff" if ext in ("aif", "aiff", "aifc")
                else "au" if ext in ("au", "snd")
                else "caf" if ext == "caf" else "wav")
    magic = bytes(src[:4])
    return ("aiff" if magic == b"FORM" else "au" if magic == b".snd"
            else "caf" if magic == b"caff" else "wav")


_HEADERS = {
    "wav": (parse_wav_header, _wav.unpack_args),
    "aiff": (parse_aiff_header, _aiff.unpack_args),
    "au": (parse_au_header, _au.unpack_args),
    "caf": (parse_caf_header, _caf.unpack_args),
}


class PcmStream:
    """Chunked single-file WAV/AIFF/AU/CAF decode on ``device``: fixed
    frame windows through the batch path's unpackers, O(chunk) host and
    device memory (the file is memory-mapped when given a path).
    Concatenated chunks equal the one-shot decode;
    ``chunks(start_sample=N)`` seeks exactly (PCM has no cross-frame
    state; block codecs seek at their block quantum)."""

    def __init__(self, src, *, container: str | None = None,
                 frames_per_chunk: int = 1 << 17, device="cuda"):
        from .registry import resolve_device

        self.device = resolve_device(device)
        if frames_per_chunk < 1:
            raise ValueError("frames_per_chunk must be >= 1")
        if isinstance(src, str):
            try:
                mm = np.memmap(src, dtype=np.uint8, mode="r")
            except (OSError, ValueError) as e:
                raise E.IoError(str(e)) from e
        else:
            mm = np.frombuffer(src, dtype=np.uint8)
        container = container or container_for(src)
        if container not in _HEADERS:
            raise ValueError(f"container {container!r}")
        parse, unpack_args = _HEADERS[container]
        self._mm = mm
        self.container = container
        self.meta = meta = parse(mm)
        self._kw = unpack_args(meta)
        self.channels = meta["channels"]
        self.sample_rate = meta["sample_rate"]
        self.bits = meta["bits"]
        self.total_samples = meta["n_frames"]
        self.fpc = int(frames_per_chunk)
        self._adpcm = self._kw.pop("adpcm", None)
        if self._adpcm:
            ch = self.channels
            ba = self._kw["block_align"]
            self._kw = {} if self._adpcm == "ima4" else dict(block_align=ba)
            if self._adpcm == "ima":
                self._spb = 1 + 8 * ((ba - 4 * ch) // (4 * ch))
            elif self._adpcm == "ms":
                self._spb = 2 + (ba - 7 * ch) * 2 // ch
            else:  # ima4: 34-byte packets per channel, 64 frames
                self._spb = 64
            self._ba = ba  # bytes per block (the seek quantum's)
        else:
            # bytes per frame follows the STORED width (the unpack
            # config's bits), not COMM's decoded sampleSize — AIFC
            # ulaw/alaw store one byte per sample while declaring 16
            self._bpf = self.channels * (self._kw["bits"] // 8)

    def _windows(self, start_sample: int):
        """(first frame, frames, byte offset, bytes) of every chunk: frame
        windows for PCM, whole blocks for ADPCM (from the enclosing
        block of ``start_sample``)."""
        base = self.meta["data_off"]
        if not self._adpcm:
            for f0 in range(start_sample, self.total_samples, self.fpc):
                yield (f0, min(self.fpc, self.total_samples - f0),
                       base + f0 * self._bpf, self.fpc * self._bpf)
            return
        spb = self._spb
        bpc = max(self.fpc // spb, 1)  # blocks per chunk
        first = start_sample - start_sample % spb
        for f0 in range(first, self.total_samples, bpc * spb):
            yield (f0, min(bpc * spb, self.total_samples - f0),
                   base + (f0 // spb) * self._ba, bpc * self._ba)

    def chunks(self, start_sample: int = 0):
        """Yield float32 [frames, channels] host chunks; `start_sample`
        seeks (output == one-shot ``pcm[start_sample:]`` bit-exactly).

        Every chunk is one fixed shape: its bytes are copied from the
        map into one host buffer (pinned for a CUDA device), the tail
        window zero-padded, and unpacked on the device."""
        if not 0 <= start_sample <= self.total_samples:
            raise ValueError(
                f"start_sample {start_sample} outside"
                f" [0, {self.total_samples}]")
        dev = self.device
        if self._adpcm:
            span_frames = max(self.fpc // self._spb, 1) * self._spb
        else:
            span_frames = self.fpc
        host = None
        off = torch.zeros((1,), dtype=torch.int32, device=dev)
        for f0, n, b0, span in self._windows(start_sample):
            if host is None:
                host = torch.empty((1, span), dtype=torch.uint8,
                                   pin_memory=dev.type == "cuda")
            view = host.numpy()[0]
            raw = self._mm[b0 : b0 + span]
            view[: len(raw)] = raw
            view[len(raw):] = 0  # tail window: zero-pad to the one shape
            bufs = host.to(dev, non_blocking=True)
            n_t = torch.full((1,), n, dtype=torch.int32, device=dev)
            if self._adpcm:
                pcm = _ADPCM[self._adpcm](
                    bufs, off, n_t, channels=self.channels,
                    max_frames=span_frames, **self._kw)
            else:
                pcm = unpack_pcm(bufs, off, n_t, channels=self.channels,
                                 max_frames=span_frames, **self._kw)
            # the unpackers emit flat interleaved [B, S*C]; the host
            # reshape is free, and the copy syncs before the buffer is
            # refilled
            out = pcm[0].cpu().numpy().reshape(-1, self.channels)[:n]
            trim = start_sample - f0
            if trim > 0:
                out = out[trim:]
            if out.shape[0]:  # a seek to EOF mid-block yields nothing
                yield out

    def __iter__(self):
        return self.chunks()
