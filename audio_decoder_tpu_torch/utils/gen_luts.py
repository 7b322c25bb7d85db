"""Generate ``huffman_lut.h``, the flat Huffman decode tables of mp3fe.

The C++ MP3 front-end (``native/mp3fe.cc``) includes ``huffman_lut.h``.
The header is not committed with the port: it is generated at build time
from the port's own ISO table data (``codecs/mpeg/huffman_tables.py``)
into the gitignored build directory, with the same text the JAX package's
generator writes, so both front-ends decode from one table source.

Big-value tables become one flat prefix LUT each (indexed by the next
``maxlen`` bits → packed ``len<<8 | x<<4 | y``); count1 tables become
6-bit LUTs (``len<<4 | v``).
"""

from __future__ import annotations

import hashlib
import os
import threading

from ..codecs.mpeg import huffman_tables as HT

_lock = threading.Lock()


def _emit_table(name: str, entries: list[int], per_line: int = 12) -> str:
    lines = [f"static const uint16_t {name}[{len(entries)}] = {{"]
    for i in range(0, len(entries), per_line):
        lines.append("  " + ", ".join(str(v) for v in entries[i: i + per_line]) + ",")
    lines.append("};")
    return "\n".join(lines)


def _big_lut(codes: dict) -> tuple[int, list[int]]:
    maxlen = max(length for (length, _code) in codes.values())
    lut = [0] * (1 << maxlen)
    for (x, y), (length, code) in codes.items():
        lo = code << (maxlen - length)
        hi = (code + 1) << (maxlen - length)
        if any(lut[lo:hi]):
            raise ValueError("overlapping Huffman codes")
        lut[lo:hi] = [(length << 8) | (x << 4) | y] * (hi - lo)
    return maxlen, lut


def _count1_lut(codes: dict) -> list[int]:
    lut = [0] * 64
    for v, (length, code) in codes.items():
        lo = code << (6 - length)
        hi = (code + 1) << (6 - length)
        if any(lut[lo:hi]):
            raise ValueError("overlapping count1 codes")
        lut[lo:hi] = [(length << 4) | v] * (hi - lo)
    return lut


def huffman_lut_text() -> str:
    """The text of ``huffman_lut.h``."""
    parts = [
        "// GENERATED by tools/gen_mp3fe_luts.py — do not edit.",
        "// Flat Huffman prefix LUTs from ISO/IEC 11172-3 Table B.7 data",
        "// (single source of truth: audio_decoder_tpu/codecs/mpeg/huffman_tables.py).",
        "#pragma once",
        "#include <stdint.h>",
        "",
    ]
    widths = {}
    for t in sorted(HT.BIG_TABLES):
        maxlen, lut = _big_lut(HT.BIG_TABLES[t])
        widths[t] = maxlen
        parts.append(_emit_table(f"kBig{t}", lut))
        parts.append("")

    # table id → (lut ptr, width); id 0 = all-zero table, ids 4/14 reserved
    parts.append("struct BigLut { const uint16_t* lut; int bits; };")
    rows = [f"  {{kBig{t}, {widths[t]}}}," if t in widths else "  {nullptr, 0},"
            for t in range(32)]
    parts.append("static const BigLut kBigLuts[32] = {\n" + "\n".join(rows) + "\n};")
    parts.append("")

    # header table_select → (big table id, linbits); -1 id = reserved
    tid = [HT.TABLE_INFO[i][0] for i in range(32)]
    lin = [HT.TABLE_INFO[i][1] for i in range(32)]
    parts.append("static const int8_t kTableId[32] = {" + ", ".join(map(str, tid)) + "};")
    parts.append("static const int8_t kLinbits[32] = {" + ", ".join(map(str, lin)) + "};")
    parts.append("")

    for s in (0, 1):
        parts.append(_emit_table(f"kCount1_{s}", _count1_lut(HT.COUNT1_TABLES[s])))
    parts.append("static const uint16_t* kCount1Luts[2] = {kCount1_0, kCount1_1};")
    parts.append("")
    return "\n".join(parts)


def huffman_lut_header(build_dir: str) -> str:
    """Path of ``huffman_lut.h`` under ``build_dir``, generated if missing.

    The header goes to ``gen/<hash>/`` named by a hash of its inputs (this
    module and the table module), so an existing file is current and is
    not regenerated.  The write goes through a private temporary file and
    a rename, so concurrent processes never read a half-written header."""
    h = hashlib.sha256()
    for mod in (__file__, HT.__file__):
        with open(mod, "rb") as f:
            h.update(f.read())
    directory = os.path.join(build_dir, "gen", h.hexdigest()[:16])
    path = os.path.join(directory, "huffman_lut.h")
    with _lock:
        if not os.path.exists(path):
            os.makedirs(directory, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                f.write(huffman_lut_text().encode())
            os.replace(tmp, path)
    return path
