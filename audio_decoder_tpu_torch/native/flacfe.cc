// Verbatim copy of audio_decoder_tpu/native/flacfe.cc (the port builds its own copy with g++).
// flacfe — bit-serial fast paths for the FLAC host structural walk.
//
// The FLAC walk (audio_decoder_tpu/codecs/flac/frontend.py) only needs
// frame/subframe/partition BOUNDARIES on the host — the TPU does the
// actual entropy decode — but finding a partition's end still means
// stepping every rice code's unary run.  That inner loop (and the
// per-frame CRC-8/16 validation) is the same bit-serial work the MPEG
// family puts in mp3fe.cc; this file gives the FLAC walk the same
// native core.  The Python implementations in frontend.py remain the
// behavioral contract and the fallback when no toolchain is present.
//
// Role parity note: the reference project keeps all of its bit cursors
// on the host CPU (blast/src/file_parsing/*.rs); here only the
// structure-finding cursor does, and it runs in C.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// 64-bit big-endian window at an arbitrary bit position: the top
// 64 - (pos & 7) bits are stream bits, the rest shifted-in zeros.
// Fast path is a single unaligned load + byteswap; only positions
// within 8 bytes of the buffer end take the byte-serial tail.
inline uint64_t win64(const uint8_t* buf, int64_t nbytes, int64_t bitpos) {
    int64_t byte = bitpos >> 3;
    uint64_t w;
    if (nbytes - byte >= 8) {
        std::memcpy(&w, buf + byte, 8);
        w = __builtin_bswap64(w);
    } else {
        w = 0;
        for (int i = 0; i < 8; ++i)
            w = (w << 8) | (byte + i < nbytes ? buf[byte + i] : 0);
    }
    return w << (bitpos & 7);
}

uint8_t CRC8_TAB[256];
uint16_t CRC16_TAB[8][256];  // [0] = byte-at-a-time; [k] = b then k zero bytes
std::once_flag tabs_once;

// callers race here: decode_group threads the per-file walk and the
// ctypes calls drop the GIL, so first-touch must be call_once, not a
// check-then-write flag
void init_tabs() {
    std::call_once(tabs_once, [] {
        for (int b = 0; b < 256; ++b) {
            uint32_t r = b;
            for (int i = 0; i < 8; ++i)
                r = (r & 0x80) ? ((r << 1) ^ 0x07) & 0xFF : (r << 1) & 0xFF;
            CRC8_TAB[b] = (uint8_t)r;
            r = b << 8;
            for (int i = 0; i < 8; ++i)
                r = (r & 0x8000) ? ((r << 1) ^ 0x8005) & 0xFFFF
                                 : (r << 1) & 0xFFFF;
            CRC16_TAB[0][b] = (uint16_t)r;
        }
        // slice-by-8 companion tables: advance through one more zero byte
        for (int k = 1; k < 8; ++k)
            for (int b = 0; b < 256; ++b) {
                uint16_t p = CRC16_TAB[k - 1][b];
                CRC16_TAB[k][b] =
                    CRC16_TAB[0][p >> 8] ^ (uint16_t)((p << 8) & 0xFFFF);
            }
    });
}

// CRC-16 poly 0x8005 init 0, slice-by-8: eight independent table lookups
// per 8 bytes instead of an 8-deep serial chain.
inline uint32_t crc16_run(const uint8_t* buf, int64_t len) {
    uint32_t r = 0;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
        const uint8_t* d = buf + i;
        r = CRC16_TAB[7][(r >> 8) ^ d[0]] ^ CRC16_TAB[6][(r & 0xFF) ^ d[1]] ^
            CRC16_TAB[5][d[2]] ^ CRC16_TAB[4][d[3]] ^ CRC16_TAB[3][d[4]] ^
            CRC16_TAB[2][d[5]] ^ CRC16_TAB[1][d[6]] ^ CRC16_TAB[0][d[7]];
    }
    for (; i < len; ++i)
        r = CRC16_TAB[0][((r >> 8) ^ buf[i]) & 0xFF] ^ ((r << 8) & 0xFFFF);
    return r;
}

}  // namespace

extern "C" {

// Advance past `count` rice codes with parameter `param` starting at bit
// `pos` of an `nbits`-bit stream.  Quotient outliers (q > q_cap) are
// written to `out` as (code_idx, end_bitpos, unzigzagged_value) triples,
// capacity `cap` triples.  When `split` > 0, the bit position BEFORE
// code j is recorded in `splits[j/split - 1]` for every positive
// multiple j of `split` below `count` (capacity (count-1)/split, exact
// by construction) — the walk uses these to cut long partitions into
// bounded device lanes.  Returns the new bit position, -1 if any code
// runs past the end of the stream, -2 on outlier-capacity overflow.
int64_t flacfe_skip_rice(const uint8_t* buf, int64_t nbits, int64_t pos,
                         int64_t count, int32_t param, int32_t q_cap,
                         int64_t* out, int64_t cap, int64_t* n_out,
                         int64_t split, int64_t* splits) {
    const int64_t nbytes = (nbits + 7) >> 3;
    int64_t nout = 0;
    for (int64_t j = 0; j < count; ++j) {
        if (split > 0 && j > 0 && j % split == 0) splits[j / split - 1] = pos;
        int64_t q;
        uint64_t rem = 0;
        // fast path: the whole code in one >=57-valid-bit window read
        uint64_t w0 = win64(buf, nbytes, pos);
        int lz0 = w0 ? __builtin_clzll(w0) : 64;
        if (lz0 + 1 + param <= 57) {
            if (pos + lz0 >= nbits) return -1;  // stop bit past end
            q = lz0;
            if (param > 0) rem = (w0 << (lz0 + 1)) >> (64 - param);
            pos += lz0 + 1 + param;
            if (pos > nbits) return -1;
        } else {
            q = 0;
            for (;;) {
                if (pos >= nbits) return -1;
                uint64_t w = win64(buf, nbytes, pos);
                if (w == 0) { q += 56; pos += 56; continue; }
                int lz = __builtin_clzll(w);
                if (lz >= 56) { q += 56; pos += 56; continue; }
                q += lz;
                pos += lz;
                if (pos >= nbits) return -1;  // stop bit past end of stream
                pos += 1;
                break;
            }
            if (param > 0) {
                rem = win64(buf, nbytes, pos) >> (64 - param);
                pos += param;
            }
            if (pos > nbits) return -1;
        }
        if (q > q_cap) {
            if (nout >= cap) return -2;
            uint64_t u = ((uint64_t)q << param) | rem;
            int64_t v = (int64_t)(u >> 1);
            if (u & 1) v = ~v;  // unzigzag: (u >> 1) ^ -(u & 1)
            out[nout * 3 + 0] = j;
            out[nout * 3 + 1] = pos;
            out[nout * 3 + 2] = v;
            ++nout;
        }
    }
    *n_out = nout;
    return pos;
}

// Frame-header CRC-8 (poly 0x07, init 0) / whole-frame CRC-16
// (poly 0x8005, init 0) — same contracts as frontend.crc8/crc16.
uint32_t flacfe_crc8(const uint8_t* buf, int64_t len) {
    init_tabs();
    uint32_t r = 0;
    for (int64_t i = 0; i < len; ++i) r = CRC8_TAB[r ^ buf[i]];
    return r;
}

uint32_t flacfe_crc16(const uint8_t* buf, int64_t len) {
    init_tabs();
    return crc16_run(buf, len);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-file walker (session API).
//
// The skip_rice/crc entry points above accelerate the *inner loops* of the
// Python structural walk; a 30 s file still pays ~10^4 Python-level
// frame/subframe/partition iterations.  The session API below walks entire
// files in C — streaminfo, every frame header (CRC-8/16 validated), subframe
// headers, partition loops — and emits the FlacAnalysis descriptor arrays
// directly, threaded across files, the same shape as mp3fe's session API
// (native/mp3fe.cc mp3fe_open_batch).  The Python walk in
// codecs/flac/frontend.py remains the behavioral contract: parity is pinned
// field-for-field in tests/test_flac_native.py, and any file the walker
// rejects (err != 0) is re-walked in Python so the error taxonomy and
// messages stay authoritative.
// ---------------------------------------------------------------------------

namespace {

// core/errors.py vectorized codes
constexpr int32_t kErrEof = 1;      // UnexpectedEofError
constexpr int32_t kErrUnsup = 2;    // UnsupportedFormatError
constexpr int32_t kErrInvalid = 3;  // InvalidDataError

std::atomic<int64_t> g_walks{0};  // whole-file walks (test pin counter)

struct WalkOut {
  int32_t err = 0;
  int32_t rate = 0, channels = 0, bits = 0;
  int64_t total = 0;  // STREAMINFO total (0 = unknown)
  int64_t got = 0;    // samples actually walked
  int64_t frames_start = 0;
  uint8_t md5[16] = {0};
  bool dv_ovf = false;  // host-decoded outlier exceeded int32
  std::vector<int32_t> blocksizes, ch_mode;
  std::vector<int64_t> starts, byte_offs;
  std::vector<int32_t> sub_frame, sub_ch, sub_kind, sub_order, sub_shift,
      sub_wasted, sub_coeffs /* S*32 */;
  std::vector<int32_t> rl_sub, rl_count, rl_param, rl_dest;
  std::vector<int64_t> rl_bitpos;
  std::vector<int32_t> fw_sub, fw_count, fw_width, fw_dest;
  std::vector<int64_t> fw_bitpos;
  std::vector<int32_t> dv_sub, dv_dest;
  std::vector<int64_t> dv_val;
};

struct Cur {
  const uint8_t* buf;
  int64_t nbytes, nbits, pos;
};

// n <= 32 bits MSB-first at the cursor; false = past end of stream
// (mirrors _Bits.u, frontend.py).
inline bool rd(Cur& c, int n, uint32_t* out) {
  if (c.pos + n > c.nbits) return false;
  *out = n ? (uint32_t)(win64(c.buf, c.nbytes, c.pos) >> (64 - n)) : 0;
  c.pos += n;
  return true;
}

// unary run (count of 0s before the stop 1-bit); false = no stop bit
// before end of stream (mirrors _Bits.unary).
inline bool rd_unary(Cur& c, int64_t* q) {
  int64_t pos = c.pos, n = 0;
  for (;;) {
    if (pos >= c.nbits) return false;
    uint64_t w = win64(c.buf, c.nbytes, pos);
    int lz = w ? __builtin_clzll(w) : 64;
    if (lz >= 56) {  // window tail is shifted-in zeros; step a full 56
      n += 56;
      pos += 56;
      continue;
    }
    n += lz;
    pos += lz;
    if (pos >= c.nbits) return false;  // stop bit past end
    c.pos = pos + 1;
    *q = n;
    return true;
  }
}

inline bool fail(WalkOut& o, int32_t code) {
  o.err = code;
  return false;
}

// Cached MSB-first bit buffer for the rice hot loop: `bb` holds the next
// `nb` stream bits left-aligned (bits at index >= nb are zero), `bytepos`
// is the next unread byte.  Absolute bit position = bytepos*8 - nb.
// refill() tops up to >= 57 valid bits whenever 8 source bytes remain, so
// a whole typical rice code (unary run + stop bit + remainder) is served
// from registers — one unaligned load per ~5 codes instead of 2-3 per code.
inline void bb_refill(const uint8_t* buf, int64_t nbytes, int64_t& bytepos,
                      uint64_t& bb, int& nb) {
  if (nb >= 57) return;
  if (bytepos + 8 <= nbytes) {
    uint64_t w;
    std::memcpy(&w, buf + bytepos, 8);
    w = __builtin_bswap64(w);
    const int take = (64 - nb) & ~7;  // whole bytes; lands nb in [57, 64]
    bb |= (w >> nb) & (~0ULL << (64 - nb - take));
    nb += take;
    bytepos += take >> 3;
  } else {
    while (nb <= 56 && bytepos < nbytes) {
      bb |= (uint64_t)buf[bytepos++] << (56 - nb);
      nb += 8;
    }
  }
}

inline void emit_rl(WalkOut& o, int32_t sub, int64_t bitpos, int64_t count,
                    int32_t param, int64_t dest) {
  o.rl_sub.push_back(sub);
  o.rl_bitpos.push_back(bitpos);
  o.rl_count.push_back((int32_t)count);
  o.rl_param.push_back(param);
  o.rl_dest.push_back((int32_t)dest);
}

// One residual section (mirrors frontend._walk_residual, including the
// merged RICE_SPLIT-boundary / quotient-outlier lane cuts — here the cuts
// fall out of the sequential code scan instead of a post-merge).
bool walk_res(Cur& c, WalkOut& o, int32_t sub_idx, int32_t n, int32_t order,
              int32_t q_cap, int64_t split) {
  uint32_t method, po4;
  if (!rd(c, 2, &method)) return fail(o, kErrEof);
  if (method > 1) return fail(o, kErrInvalid);
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  if (!rd(c, 4, &po4)) return fail(o, kErrEof);
  const int64_t npart = 1LL << po4;
  const int64_t psize = (int64_t)n >> po4;
  if (n % npart || psize < order) return fail(o, kErrInvalid);
  for (int64_t p = 0; p < npart; ++p) {
    const int64_t cnt = psize - (p == 0 ? order : 0);
    const int64_t dest = p == 0 ? order : p * psize;
    uint32_t param;
    if (!rd(c, pbits, &param)) return fail(o, kErrEof);
    if (param == escape) {
      uint32_t width;
      if (!rd(c, 5, &width)) return fail(o, kErrEof);
      o.fw_sub.push_back(sub_idx);
      o.fw_bitpos.push_back(c.pos);
      o.fw_count.push_back((int32_t)cnt);
      o.fw_width.push_back((int32_t)width);
      o.fw_dest.push_back((int32_t)dest);
      c.pos += cnt * width;
      if (c.pos > c.nbits) return fail(o, kErrEof);
    } else {
      int64_t prev_j = 0, prev_pos = c.pos;
      int64_t next_split = split > 0 ? split : INT64_MAX;
      // cached bit buffer over [c.pos, ...): init at the byte under c.pos,
      // then discard the partial-byte bits
      uint64_t bb = 0;
      int nb = 0;
      int64_t bytepos = c.pos >> 3;
      bb_refill(c.buf, c.nbytes, bytepos, bb, nb);
      {
        const int skip = (int)(c.pos & 7);
        bb <<= skip;
        nb -= skip;
      }
      for (int64_t j = 0; j < cnt; ++j) {
        if (j == next_split) {
          if (j > prev_j)
            emit_rl(o, sub_idx, prev_pos, j - prev_j, param,
                    dest + prev_j);
          prev_j = j;
          prev_pos = bytepos * 8 - nb;
          next_split += split;
        }
        bb_refill(c.buf, c.nbytes, bytepos, bb, nb);
        int lz = bb ? __builtin_clzll(bb) : 64;
        int64_t q;
        uint64_t rem = 0;
        const int k = lz + 1 + param;
        if (k <= nb) {  // whole code served from the register
          q = lz;
          if (q > q_cap && param > 0)  // remainder only read for outliers
            rem = (bb << (lz + 1)) >> (64 - param);
          if (k < 64)
            bb <<= k;
          else
            bb = 0;
          nb -= k;
        } else {
          // long unary run or stream tail: sync the cursor, take the
          // generic bounds-checked path, re-seat the buffer
          c.pos = bytepos * 8 - nb;
          if (!rd_unary(c, &q)) return fail(o, kErrEof);
          if (param > 0) {
            rem = win64(c.buf, c.nbytes, c.pos) >> (64 - param);
            c.pos += param;
          }
          if (c.pos > c.nbits) return fail(o, kErrEof);
          bb = 0;
          nb = 0;
          bytepos = c.pos >> 3;
          bb_refill(c.buf, c.nbytes, bytepos, bb, nb);
          const int skip = (int)(c.pos & 7);
          bb <<= skip;
          nb -= skip;
        }
        if (q > q_cap) {
          const int64_t here = bytepos * 8 - nb;
          if (j > prev_j)
            emit_rl(o, sub_idx, prev_pos, j - prev_j, param,
                    dest + prev_j);
          uint64_t u = ((uint64_t)q << param) | rem;
          int64_t v = (int64_t)(u >> 1);
          if (u & 1) v = ~v;  // unzigzag
          if (v > INT32_MAX || v < INT32_MIN) o.dv_ovf = true;
          o.dv_sub.push_back(sub_idx);
          o.dv_dest.push_back((int32_t)(dest + j));
          o.dv_val.push_back(v);
          prev_j = j + 1;
          prev_pos = here;
        }
      }
      c.pos = bytepos * 8 - nb;
      if (c.pos > c.nbits) return fail(o, kErrEof);
      if (cnt > prev_j)
        emit_rl(o, sub_idx, prev_pos, cnt - prev_j, param, dest + prev_j);
    }
  }
  return true;
}

// One subframe header + body (mirrors frontend._walk_subframe).
bool walk_sub(Cur& c, WalkOut& o, int32_t sub_idx, int32_t n, int32_t bps,
              int32_t q_cap, int64_t split) {
  uint32_t v, ftype;
  if (!rd(c, 1, &v)) return fail(o, kErrEof);
  if (v != 0) return fail(o, kErrInvalid);  // subframe padding bit set
  if (!rd(c, 6, &ftype)) return fail(o, kErrEof);
  int32_t wasted = 0;
  if (!rd(c, 1, &v)) return fail(o, kErrEof);
  if (v) {
    int64_t q;
    if (!rd_unary(c, &q)) return fail(o, kErrEof);
    wasted = (int32_t)q + 1;
    bps -= wasted;
    if (bps <= 0) return fail(o, kErrInvalid);
  }
  int32_t coeffs[32] = {0};
  int32_t kind = 0, order = 0, shift = 0;
  if (ftype == 0) {  // CONSTANT
    o.fw_sub.push_back(sub_idx);
    o.fw_bitpos.push_back(c.pos);
    o.fw_count.push_back(1);
    o.fw_width.push_back(bps);
    o.fw_dest.push_back(0);
    c.pos += bps;
    kind = 1;
  } else if (ftype == 1) {  // VERBATIM — LPC order 0
    o.fw_sub.push_back(sub_idx);
    o.fw_bitpos.push_back(c.pos);
    o.fw_count.push_back(n);
    o.fw_width.push_back(bps);
    o.fw_dest.push_back(0);
    c.pos += (int64_t)n * bps;
    if (c.pos > c.nbits) return fail(o, kErrEof);
  } else if (ftype >= 8 && ftype <= 12) {  // FIXED
    order = (int32_t)(ftype & 7);
    if (order > n) return fail(o, kErrInvalid);
    o.fw_sub.push_back(sub_idx);
    o.fw_bitpos.push_back(c.pos);
    o.fw_count.push_back(order);
    o.fw_width.push_back(bps);
    o.fw_dest.push_back(0);
    c.pos += (int64_t)order * bps;
    static const int32_t kFixed[5][4] = {
        {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
        {3, -3, 1, 0}, {4, -6, 4, -1}};
    for (int j = 0; j < order; ++j) coeffs[j] = kFixed[order][j];
    if (!walk_res(c, o, sub_idx, n, order, q_cap, split)) return false;
  } else if (ftype >= 32) {  // LPC
    order = (int32_t)(ftype & 31) + 1;
    if (order > n) return fail(o, kErrInvalid);
    o.fw_sub.push_back(sub_idx);
    o.fw_bitpos.push_back(c.pos);
    o.fw_count.push_back(order);
    o.fw_width.push_back(bps);
    o.fw_dest.push_back(0);
    c.pos += (int64_t)order * bps;
    if (c.pos > c.nbits) return fail(o, kErrEof);
    uint32_t prec4, sh5;
    if (!rd(c, 4, &prec4)) return fail(o, kErrEof);
    const int prec = (int)prec4 + 1;
    if (prec == 16) return fail(o, kErrInvalid);  // precision escape
    if (!rd(c, 5, &sh5)) return fail(o, kErrEof);
    int32_t sv = (int32_t)sh5;
    if (sv >= 16) sv -= 32;  // s(5)
    if (sv < 0) return fail(o, kErrInvalid);
    shift = sv;
    for (int j = 0; j < order; ++j) {
      uint32_t cv;
      if (!rd(c, prec, &cv)) return fail(o, kErrEof);
      int32_t sc = (int32_t)cv;
      if (sc >= (1 << (prec - 1))) sc -= (1 << prec);
      coeffs[j] = sc;
    }
    if (!walk_res(c, o, sub_idx, n, order, q_cap, split)) return false;
  } else {
    return fail(o, kErrInvalid);  // reserved subframe type
  }
  o.sub_kind.push_back(kind);
  o.sub_order.push_back(order);
  o.sub_shift.push_back(shift);
  o.sub_wasted.push_back(wasted);
  o.sub_coeffs.insert(o.sub_coeffs.end(), coeffs, coeffs + 32);
  return true;
}

// UTF-8-style coded number; the value only feeds the header CRC, so it is
// validated and discarded (mirrors frontend._read_utf8 + `del number`).
bool read_utf8(Cur& c, WalkOut& o) {
  uint32_t b0;
  if (!rd(c, 8, &b0)) return fail(o, kErrEof);
  if (b0 < 0x80) return true;
  int nf = 0;
  uint32_t mask = 0x40;
  while (b0 & mask) {
    ++nf;
    mask >>= 1;
  }
  if (nf == 0) return fail(o, kErrInvalid);
  for (int i = 0; i < nf; ++i) {
    uint32_t cb;
    if (!rd(c, 8, &cb)) return fail(o, kErrEof);
    if ((cb & 0xC0) != 0x80) return fail(o, kErrInvalid);
  }
  return true;
}

// Full walk of one stream (mirrors frontend.parse_streaminfo + analyze).
// Caps are parameters so the Python constants stay the single source:
// max_bps ≙ frontend.MAX_BPS, bit_cap ≙ frontend.BIT_CAP.
void walk_file(const uint8_t* buf, int64_t len, int32_t q_cap, int64_t split,
               int32_t max_bps, int64_t bit_cap, WalkOut& o) {
  g_walks.fetch_add(1, std::memory_order_relaxed);
  init_tabs();
  static const int32_t kBlock[16] = {0,   192,  576,  1152,  2304,  4608,
                                     0,   0,    256,  512,   1024,  2048,
                                     4096, 8192, 16384, 32768};
  static const int32_t kBps[8] = {0, 8, 12, 0, 16, 20, 24, 32};

  // --- metadata (parse_streaminfo)
  int64_t off = 0;
  if (len >= 3 && !memcmp(buf, "ID3", 3)) {
    if (len < 10) {
      o.err = kErrEof;
      return;
    }
    int64_t sz = ((int64_t)(buf[6] & 0x7F) << 21) |
                 ((int64_t)(buf[7] & 0x7F) << 14) |
                 ((int64_t)(buf[8] & 0x7F) << 7) | (buf[9] & 0x7F);
    off = 10 + sz + ((buf[5] & 0x10) ? 10 : 0);
  }
  if (off + 4 > len || memcmp(buf + off, "fLaC", 4)) {
    o.err = kErrInvalid;
    return;
  }
  int64_t pos = off + 4;
  bool have_info = false, last = false;
  while (!last) {
    if (pos + 4 > len) {
      o.err = kErrEof;
      return;
    }
    last = buf[pos] >> 7;
    const int btype = buf[pos] & 0x7F;
    const int64_t size =
        ((int64_t)buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    if (pos + 4 + size > len) {
      o.err = kErrEof;
      return;
    }
    if (btype == 0) {
      if (size < 34) {
        o.err = kErrInvalid;
        return;
      }
      const uint8_t* b = buf + pos + 4;
      o.rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4);
      o.channels = ((b[12] >> 1) & 7) + 1;
      o.bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      o.total = ((int64_t)(b[13] & 0xF) << 32) | ((int64_t)b[14] << 24) |
                ((int64_t)b[15] << 16) | ((int64_t)b[16] << 8) | b[17];
      memcpy(o.md5, b + 18, 16);
      have_info = true;
    } else if (btype == 127) {
      o.err = kErrInvalid;
      return;
    }
    pos += 4 + size;
  }
  if (!have_info || o.rate == 0) {
    o.err = kErrInvalid;
    return;
  }
  o.frames_start = pos;
  // analyze()-level caps, in its order
  if (len * 8 >= bit_cap) {
    o.err = kErrUnsup;
    return;
  }
  if (o.bits > max_bps) {
    o.err = kErrUnsup;
    return;
  }

  // --- frame loop (analyze)
  Cur c{buf, len, len * 8, pos * 8};
  const int64_t end_bits = len * 8;
  int64_t got = 0;
  while (c.pos + 16 <= end_bits && (o.total == 0 || got < o.total)) {
    const int64_t frame_off = c.pos >> 3;
    uint32_t sync, v, bs_code, rate_code, ch_code, ss_code;
    if (!rd(c, 14, &sync) || !rd(c, 1, &v)) {
      o.err = kErrEof;
      return;
    }
    if (sync != 0x3FFE || v != 0) {
      o.err = kErrInvalid;  // lost sync / reserved bit
      return;
    }
    if (!rd(c, 1, &v) /* variable-blocksize flag (unused) */ ||
        !rd(c, 4, &bs_code) || !rd(c, 4, &rate_code) || !rd(c, 4, &ch_code) ||
        !rd(c, 3, &ss_code) || !rd(c, 1, &v)) {
      o.err = kErrEof;
      return;
    }
    if (v != 0) {
      o.err = kErrInvalid;  // reserved frame header bit 2
      return;
    }
    if (!read_utf8(c, o)) return;
    int32_t n;
    if (bs_code == 0) {
      o.err = kErrInvalid;
      return;
    } else if (bs_code == 6) {
      if (!rd(c, 8, &v)) {
        o.err = kErrEof;
        return;
      }
      n = (int32_t)v + 1;
    } else if (bs_code == 7) {
      if (!rd(c, 16, &v)) {
        o.err = kErrEof;
        return;
      }
      n = (int32_t)v + 1;
    } else {
      n = kBlock[bs_code];
    }
    if (rate_code == 12) {
      if (!rd(c, 8, &v)) {
        o.err = kErrEof;
        return;
      }
    } else if (rate_code == 13 || rate_code == 14) {
      if (!rd(c, 16, &v)) {
        o.err = kErrEof;
        return;
      }
    } else if (rate_code == 15) {
      o.err = kErrInvalid;
      return;
    }
    if (ss_code == 3) {
      o.err = kErrInvalid;  // reserved sample size code
      return;
    }
    const int32_t bps = ss_code == 0 ? o.bits : kBps[ss_code];
    if (bps > max_bps) {
      o.err = kErrUnsup;
      return;
    }
    const int64_t hdr_end = c.pos >> 3;
    uint32_t crc;
    if (!rd(c, 8, &crc)) {
      o.err = kErrEof;
      return;
    }
    {
      uint32_t r = 0;
      for (int64_t i = frame_off; i < hdr_end; ++i) r = CRC8_TAB[r ^ buf[i]];
      if (r != crc) {
        o.err = kErrInvalid;  // frame header CRC-8 mismatch
        return;
      }
    }
    int32_t nch, sides[8] = {0};
    if (ch_code <= 7) {
      nch = (int32_t)ch_code + 1;
    } else if (ch_code <= 10) {
      nch = 2;
      if (ch_code == 9)
        sides[0] = 1;  // R/S: side is channel 0
      else
        sides[1] = 1;  // L/S, M/S: side is channel 1
    } else {
      o.err = kErrInvalid;  // reserved channel assignment
      return;
    }
    if (nch != o.channels) {
      o.err = kErrInvalid;  // frame channel count != STREAMINFO
      return;
    }

    o.blocksizes.push_back(n);
    o.byte_offs.push_back(frame_off);
    o.starts.push_back(got);
    o.ch_mode.push_back(ch_code >= 8 ? (int32_t)ch_code : 0);
    const int32_t fidx = (int32_t)o.blocksizes.size() - 1;
    for (int32_t ch = 0; ch < nch; ++ch) {
      const int32_t sub_idx = (int32_t)o.sub_kind.size();
      o.sub_frame.push_back(fidx);
      o.sub_ch.push_back(ch);
      if (!walk_sub(c, o, sub_idx, n, bps + sides[ch], q_cap, split)) return;
    }
    c.pos = (c.pos + 7) & ~7LL;  // align
    const int64_t body_end = c.pos >> 3;
    if (body_end + 2 > len) {
      o.err = kErrEof;  // truncated frame CRC-16
      return;
    }
    if (crc16_run(buf + frame_off, body_end - frame_off) !=
        (uint32_t)((buf[body_end] << 8) | buf[body_end + 1])) {
      o.err = kErrInvalid;  // frame CRC-16 mismatch
      return;
    }
    c.pos += 16;
    got += n;
  }
  o.byte_offs.push_back(c.pos >> 3);
  o.got = got;
  if (o.total && got < o.total) {
    o.err = kErrEof;  // stream ends before STREAMINFO total
    return;
  }
  if (o.dv_ovf) o.err = kErrUnsup;  // ≙ frontend._dv_i32 (checked last)
}

// ---------------------------------------------------------------------------
// Whole-file host DECODER — the 26-32-bit path.
//
// The device decode (codecs/flac/device.py) is exact for samples to 25
// bits (i32 predictors + f32-exact PCM); RFC 9639 allows up to 32.  The
// walker above only finds structure; this sibling decodes VALUES with
// int64 predictor arithmetic so any legal stream decodes exactly on the
// host (codecs/flac/host.py routes bps > 25 files here).  Parsing
// mirrors walk_file/walk_sub/walk_res statement-for-statement; the two
// are pinned against each other and against the clear-room Python
// decoder in tests/test_flac_host.py.
// ---------------------------------------------------------------------------

// One rice-coded residual section into dst[0..n) (positions < order
// untouched).  int64 values: q ≤ the stream's real run, no Q_CAP.
bool dec_res(Cur& c, WalkOut& o, int64_t* dst, int32_t n, int32_t order) {
  uint32_t method, po4;
  if (!rd(c, 2, &method)) return fail(o, kErrEof);
  if (method > 1) return fail(o, kErrInvalid);
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  if (!rd(c, 4, &po4)) return fail(o, kErrEof);
  const int64_t npart = 1LL << po4;
  const int64_t psize = (int64_t)n >> po4;
  if (n % npart || psize < order) return fail(o, kErrInvalid);
  for (int64_t p = 0; p < npart; ++p) {
    const int64_t cnt = psize - (p == 0 ? order : 0);
    int64_t at = p == 0 ? order : p * psize;
    uint32_t param;
    if (!rd(c, pbits, &param)) return fail(o, kErrEof);
    if (param == escape) {
      uint32_t width;
      if (!rd(c, 5, &width)) return fail(o, kErrEof);
      for (int64_t j = 0; j < cnt; ++j) {
        uint32_t u;
        if (!rd(c, (int)width, &u)) return fail(o, kErrEof);
        int64_t v = u;
        if (width > 0 && (u >> (width - 1)))
          v -= (int64_t)1 << width;  // sign extend
        dst[at++] = width ? v : 0;
      }
    } else {
      for (int64_t j = 0; j < cnt; ++j) {
        int64_t q;
        if (!rd_unary(c, &q)) return fail(o, kErrEof);
        uint64_t rem = 0;
        if (param > 0) {
          rem = win64(c.buf, c.nbytes, c.pos) >> (64 - param);
          c.pos += param;
          if (c.pos > c.nbits) return fail(o, kErrEof);
        }
        uint64_t u = ((uint64_t)q << param) | rem;
        int64_t v = (int64_t)(u >> 1);
        if (u & 1) v = ~v;  // unzigzag
        dst[at++] = v;
      }
    }
  }
  return true;
}

// One subframe into dst[0..n) as fully reconstructed samples.
bool dec_sub(Cur& c, WalkOut& o, int64_t* dst, int32_t n, int32_t bps) {
  uint32_t v, ftype;
  if (!rd(c, 1, &v)) return fail(o, kErrEof);
  if (v != 0) return fail(o, kErrInvalid);
  if (!rd(c, 6, &ftype)) return fail(o, kErrEof);
  int32_t wasted = 0;
  if (!rd(c, 1, &v)) return fail(o, kErrEof);
  if (v) {
    int64_t q;
    if (!rd_unary(c, &q)) return fail(o, kErrEof);
    wasted = (int32_t)q + 1;
    bps -= wasted;
    if (bps <= 0) return fail(o, kErrInvalid);
  }
  // ≤32-bit signed read (bps can be 33 for a wasted-less side channel
  // only via bps+1 ≤ 33; warmup/verbatim reads are ≤ 33 bits)
  auto rd_s = [&](int width, int64_t* out) -> bool {
    uint64_t u = 0;
    if (width > 32) {
      uint32_t hi32, lo32;
      if (!rd(c, width - 32, &hi32) || !rd(c, 32, &lo32)) return false;
      u = ((uint64_t)hi32 << 32) | lo32;
    } else {
      uint32_t w32;
      if (!rd(c, width, &w32)) return false;
      u = w32;
    }
    int64_t s = (int64_t)u;
    if (width > 0 && (u >> (width - 1))) s -= (int64_t)1 << width;
    *out = width ? s : 0;
    return true;
  };
  int64_t coefs[32] = {0};
  int32_t order = 0, shift = 0;
  if (ftype == 0) {  // CONSTANT
    int64_t cv;
    if (!rd_s(bps, &cv)) return fail(o, kErrEof);
    for (int32_t i = 0; i < n; ++i) dst[i] = cv;
    for (int32_t i = 0; i < n; ++i) dst[i] <<= wasted;
    return true;
  } else if (ftype == 1) {  // VERBATIM
    for (int32_t i = 0; i < n; ++i)
      if (!rd_s(bps, &dst[i])) return fail(o, kErrEof);
    for (int32_t i = 0; i < n; ++i) dst[i] <<= wasted;
    return true;
  } else if (ftype >= 8 && ftype <= 12) {  // FIXED
    order = (int32_t)(ftype & 7);
    if (order > n) return fail(o, kErrInvalid);
    static const int64_t kFixed[5][4] = {
        {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
        {3, -3, 1, 0}, {4, -6, 4, -1}};
    for (int j = 0; j < order; ++j) coefs[j] = kFixed[order][j];
    for (int32_t i = 0; i < order; ++i)
      if (!rd_s(bps, &dst[i])) return fail(o, kErrEof);
  } else if (ftype >= 32) {  // LPC
    order = (int32_t)(ftype & 31) + 1;
    if (order > n) return fail(o, kErrInvalid);
    for (int32_t i = 0; i < order; ++i)
      if (!rd_s(bps, &dst[i])) return fail(o, kErrEof);
    uint32_t prec4, sh5;
    if (!rd(c, 4, &prec4)) return fail(o, kErrEof);
    const int prec = (int)prec4 + 1;
    if (prec == 16) return fail(o, kErrInvalid);
    if (!rd(c, 5, &sh5)) return fail(o, kErrEof);
    int32_t sv = (int32_t)sh5;
    if (sv >= 16) sv -= 32;
    if (sv < 0) return fail(o, kErrInvalid);
    shift = sv;
    for (int j = 0; j < order; ++j) {
      int64_t cv;
      if (!rd_s(prec, &cv)) return fail(o, kErrEof);
      coefs[j] = cv;
    }
  } else {
    return fail(o, kErrInvalid);
  }
  if (!dec_res(c, o, dst, n, order)) return false;
  // int64 predictor recurrence: |c| < 2^15, |s| < 2^33 ⇒ 32-tap sums
  // < 2^53, exact in int64
  for (int32_t i = order; i < n; ++i) {
    int64_t acc = 0;
    for (int32_t j = 0; j < order; ++j) acc += coefs[j] * dst[i - 1 - j];
    dst[i] += acc >> shift;
  }
  if (wasted)
    for (int32_t i = 0; i < n; ++i) dst[i] <<= wasted;
  return true;
}

// Full decode of one stream into interleaved int32 PCM.  `out` capacity
// is max_samples frames; meta = (rate, channels, bits, total) on
// success.  Returns decoded frame count, or the negated error code.
int64_t dec_file(const uint8_t* buf, int64_t len, int32_t* out,
                 int64_t max_samples, int64_t* meta) {
  init_tabs();
  // metadata — reuse the walker's parse by running it with caps wide
  // open on a zero-frame prefix?  The block walk is short; repeat it.
  WalkOut hdr;
  static const int32_t kBlock[16] = {0,   192,  576,  1152,  2304,  4608,
                                     0,   0,    256,  512,   1024,  2048,
                                     4096, 8192, 16384, 32768};
  static const int32_t kBps[8] = {0, 8, 12, 0, 16, 20, 24, 32};
  int64_t off = 0;
  if (len >= 3 && !memcmp(buf, "ID3", 3)) {
    if (len < 10) return -(int64_t)kErrEof;
    int64_t sz = ((int64_t)(buf[6] & 0x7F) << 21) |
                 ((int64_t)(buf[7] & 0x7F) << 14) |
                 ((int64_t)(buf[8] & 0x7F) << 7) | (buf[9] & 0x7F);
    off = 10 + sz + ((buf[5] & 0x10) ? 10 : 0);
  }
  if (off + 4 > len || memcmp(buf + off, "fLaC", 4))
    return -(int64_t)kErrInvalid;
  int64_t pos = off + 4;
  bool have_info = false, last = false;
  int32_t rate = 0, channels = 0, bits = 0;
  int64_t total = 0;
  while (!last) {
    if (pos + 4 > len) return -(int64_t)kErrEof;
    last = buf[pos] >> 7;
    const int btype = buf[pos] & 0x7F;
    const int64_t size =
        ((int64_t)buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    if (pos + 4 + size > len) return -(int64_t)kErrEof;
    if (btype == 0) {
      if (size < 34) return -(int64_t)kErrInvalid;
      const uint8_t* b = buf + pos + 4;
      rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4);
      channels = ((b[12] >> 1) & 7) + 1;
      bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      total = ((int64_t)(b[13] & 0xF) << 32) | ((int64_t)b[14] << 24) |
              ((int64_t)b[15] << 16) | ((int64_t)b[16] << 8) | b[17];
      have_info = true;
    } else if (btype == 127) {
      return -(int64_t)kErrInvalid;
    }
    pos += 4 + size;
  }
  if (!have_info || rate == 0) return -(int64_t)kErrInvalid;

  Cur c{buf, len, len * 8, pos * 8};
  const int64_t end_bits = len * 8;
  int64_t got = 0;
  std::vector<int64_t> chan[8];
  WalkOut o;  // error-code carrier for dec_sub/dec_res
  while (c.pos + 16 <= end_bits && (total == 0 || got < total)) {
    const int64_t frame_off = c.pos >> 3;
    uint32_t sync, v, bs_code, rate_code, ch_code, ss_code;
    if (!rd(c, 14, &sync) || !rd(c, 1, &v)) return -(int64_t)kErrEof;
    if (sync != 0x3FFE || v != 0) return -(int64_t)kErrInvalid;
    if (!rd(c, 1, &v) || !rd(c, 4, &bs_code) || !rd(c, 4, &rate_code) ||
        !rd(c, 4, &ch_code) || !rd(c, 3, &ss_code) || !rd(c, 1, &v))
      return -(int64_t)kErrEof;
    if (v != 0) return -(int64_t)kErrInvalid;
    if (!read_utf8(c, o)) return -(int64_t)o.err;
    int32_t n;
    if (bs_code == 0) return -(int64_t)kErrInvalid;
    else if (bs_code == 6) {
      if (!rd(c, 8, &v)) return -(int64_t)kErrEof;
      n = (int32_t)v + 1;
    } else if (bs_code == 7) {
      if (!rd(c, 16, &v)) return -(int64_t)kErrEof;
      n = (int32_t)v + 1;
    } else {
      n = kBlock[bs_code];
    }
    if (rate_code == 12) {
      if (!rd(c, 8, &v)) return -(int64_t)kErrEof;
    } else if (rate_code == 13 || rate_code == 14) {
      if (!rd(c, 16, &v)) return -(int64_t)kErrEof;
    } else if (rate_code == 15) {
      return -(int64_t)kErrInvalid;
    }
    if (ss_code == 3) return -(int64_t)kErrInvalid;
    const int32_t bps = ss_code == 0 ? bits : kBps[ss_code];
    const int64_t hdr_end = c.pos >> 3;
    uint32_t crc;
    if (!rd(c, 8, &crc)) return -(int64_t)kErrEof;
    {
      uint32_t r = 0;
      for (int64_t i = frame_off; i < hdr_end; ++i) r = CRC8_TAB[r ^ buf[i]];
      if (r != crc) return -(int64_t)kErrInvalid;
    }
    int32_t nch, sides[8] = {0};
    if (ch_code <= 7) {
      nch = (int32_t)ch_code + 1;
    } else if (ch_code <= 10) {
      nch = 2;
      if (ch_code == 9) sides[0] = 1;
      else sides[1] = 1;
    } else {
      return -(int64_t)kErrInvalid;
    }
    if (nch != channels) return -(int64_t)kErrInvalid;
    for (int32_t ch = 0; ch < nch; ++ch) {
      chan[ch].assign(n, 0);
      if (!dec_sub(c, o, chan[ch].data(), n, bps + sides[ch]))
        return -(int64_t)o.err;
    }
    c.pos = (c.pos + 7) & ~7LL;
    const int64_t body_end = c.pos >> 3;
    if (body_end + 2 > len) return -(int64_t)kErrEof;
    if (crc16_run(buf + frame_off, body_end - frame_off) !=
        (uint32_t)((buf[body_end] << 8) | buf[body_end + 1]))
      return -(int64_t)kErrInvalid;
    c.pos += 16;
    // stereo undo (int64 intermediates; final samples fit int32)
    if (ch_code == 8) {          // left/side
      for (int32_t i = 0; i < n; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (ch_code == 9) {   // side/right
      for (int32_t i = 0; i < n; ++i) chan[0][i] += chan[1][i];
    } else if (ch_code == 10) {  // mid/side
      for (int32_t i = 0; i < n; ++i) {
        int64_t m2 = (chan[0][i] << 1) | (chan[1][i] & 1);
        chan[0][i] = (m2 + chan[1][i]) >> 1;
        chan[1][i] = (m2 - chan[1][i]) >> 1;
      }
    }
    const int64_t take = total ? (total - got < n ? total - got : n) : n;
    if (got + take > max_samples) return -(int64_t)kErrUnsup;
    for (int64_t i = 0; i < take; ++i)
      for (int32_t ch = 0; ch < nch; ++ch)
        out[(got + i) * nch + ch] = (int32_t)chan[ch][i];
    got += take;
  }
  if (total && got < total) return -(int64_t)kErrEof;
  meta[0] = rate;
  meta[1] = channels;
  meta[2] = bits;
  meta[3] = total ? total : got;
  return got;
}

}  // namespace

struct flacfe_walk_session {
  std::vector<WalkOut> files;
};

extern "C" {

// Cumulative whole-file walks (process-wide) — lets tests pin that the
// native walker actually serves the decode path, mp3fe_frame_walks-style.
int64_t flacfe_walks(void) { return g_walks.load(std::memory_order_relaxed); }

// Walk every blob once, threaded across files.  Returns a session handle;
// per-file results (including per-file error codes — the caller re-walks
// failed files in Python for the authoritative exception) are read back
// with flacfe_walk_info / flacfe_walk_fill.
flacfe_walk_session* flacfe_walk_open(const uint8_t* const* blobs,
                                      const int64_t* lens, int32_t nfiles,
                                      int32_t q_cap, int64_t split,
                                      int32_t max_bps, int64_t bit_cap,
                                      int32_t nthreads) {
  auto* s = new flacfe_walk_session;
  s->files.resize(nfiles);
  if (nthreads <= 0) {
    nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  if (nthreads > nfiles) nthreads = nfiles;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t b = next.fetch_add(1);
      if (b >= nfiles) return;
      walk_file(blobs[b], lens[b], q_cap, split, max_bps, bit_cap,
                s->files[b]);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int i = 0; i < nthreads; ++i) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return s;
}

// Per-file summary: info is [nfiles][12] int64 rows of
// (err, rate, channels, bits, total, got, frames_start, F, S, R, W, D);
// md5 is [nfiles][16] bytes.
void flacfe_walk_info(flacfe_walk_session* s, int64_t* info, uint8_t* md5) {
  for (size_t i = 0; i < s->files.size(); ++i) {
    const WalkOut& o = s->files[i];
    int64_t* r = info + i * 12;
    r[0] = o.err;
    r[1] = o.rate;
    r[2] = o.channels;
    r[3] = o.bits;
    r[4] = o.total;
    r[5] = o.got;
    r[6] = o.frames_start;
    r[7] = (int64_t)o.blocksizes.size();
    r[8] = (int64_t)o.sub_kind.size();
    r[9] = (int64_t)o.rl_sub.size();
    r[10] = (int64_t)o.fw_sub.size();
    r[11] = (int64_t)o.dv_sub.size();
    memcpy(md5 + i * 16, o.md5, 16);
  }
}

// Copy file i's descriptor arrays into caller buffers sized from
// flacfe_walk_info (byte_offs holds F+1 entries; sub_coeffs S*32).
void flacfe_walk_fill(flacfe_walk_session* s, int32_t i, int32_t* blocksizes,
                      int64_t* starts, int32_t* ch_mode, int64_t* byte_offs,
                      int32_t* sub_frame, int32_t* sub_ch, int32_t* sub_kind,
                      int32_t* sub_order, int32_t* sub_shift,
                      int32_t* sub_wasted, int32_t* sub_coeffs,
                      int32_t* rl_sub, int64_t* rl_bitpos, int32_t* rl_count,
                      int32_t* rl_param, int32_t* rl_dest, int32_t* fw_sub,
                      int64_t* fw_bitpos, int32_t* fw_count,
                      int32_t* fw_width, int32_t* fw_dest, int32_t* dv_sub,
                      int32_t* dv_dest, int32_t* dv_val) {
  const WalkOut& o = s->files[i];
  auto cp = [](auto* dst, const auto& v) {
    if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(blocksizes, o.blocksizes);
  cp(starts, o.starts);
  cp(ch_mode, o.ch_mode);
  cp(byte_offs, o.byte_offs);
  cp(sub_frame, o.sub_frame);
  cp(sub_ch, o.sub_ch);
  cp(sub_kind, o.sub_kind);
  cp(sub_order, o.sub_order);
  cp(sub_shift, o.sub_shift);
  cp(sub_wasted, o.sub_wasted);
  cp(sub_coeffs, o.sub_coeffs);
  cp(rl_sub, o.rl_sub);
  cp(rl_bitpos, o.rl_bitpos);
  cp(rl_count, o.rl_count);
  cp(rl_param, o.rl_param);
  cp(rl_dest, o.rl_dest);
  cp(fw_sub, o.fw_sub);
  cp(fw_bitpos, o.fw_bitpos);
  cp(fw_count, o.fw_count);
  cp(fw_width, o.fw_width);
  cp(fw_dest, o.fw_dest);
  cp(dv_sub, o.dv_sub);
  cp(dv_dest, o.dv_dest);
  // dv values rode int64 through the walk; err==0 guarantees i32 range
  for (size_t k = 0; k < o.dv_val.size(); ++k)
    dv_val[k] = (int32_t)o.dv_val[k];
}

void flacfe_walk_free(flacfe_walk_session* s) { delete s; }

// Whole-file host decode to interleaved int32 PCM (int64 predictor
// arithmetic — exact for every legal RFC 9639 stream incl. 32-bit).
// Returns decoded frames, or the negated core/errors code.  meta is
// (rate, channels, bits, total) int64[4].
int64_t flacfe_decode(const uint8_t* buf, int64_t len, int32_t* out,
                      int64_t max_samples, int64_t* meta) {
  return dec_file(buf, len, out, max_samples, meta);
}

}  // extern "C"
