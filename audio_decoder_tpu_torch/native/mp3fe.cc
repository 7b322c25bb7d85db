// Verbatim copy of audio_decoder_tpu/native/mp3fe.cc (the port builds its own copy with g++).
// mp3fe — native MPEG-1 Layer III bitstream front-end.
//
// The production host half of the TPU MP3 decoder: walks frames, resolves
// the bit reservoir, decodes side info / scalefactors / Huffman spectra,
// and emits the dense per-granule tensors consumed by the jitted DSP tail
// (audio_decoder_tpu/codecs/mpeg/dsp.py).  Output contract is identical to
// the pure-Python reference front-end (frontend.py) — the Python binding
// cross-validates the two in tests.
//
// The reference (gitxandert/audio_decoder) stops at frame framing
// (blast/src/file_parsing/mpeg.rs:7-128, decode TODO at main.rs:44-54);
// this file is the native green-field half, with the reference's header
// table defects corrected (SURVEY §5 items 1-5).
//
// Build: make -C audio_decoder_tpu/native   (g++ -O3, no deps)

#include <stdint.h>
#include <string.h>

#include <atomic>
#include <cmath>
#include <cstdio>
#include <mutex>
#include <thread>
#include <vector>

#include "huffman_lut.h"

namespace {

// ---------------------------------------------------------------------------
// Spec tables (ISO/IEC 11172-3) — mirror of codecs/mpeg/tables.py
// ---------------------------------------------------------------------------

// bitrate_index(1..14) x column {V1L1,V1L2,V1L3,V2L1,V2L2&3} -> kbit/s
static const int16_t kBitrate[14][5] = {
    {32, 32, 32, 32, 8},      {64, 48, 40, 48, 16},    {96, 56, 48, 56, 24},
    {128, 64, 56, 64, 32},    {160, 80, 64, 80, 40},   {192, 96, 80, 96, 48},
    {224, 112, 96, 112, 56},  {256, 128, 112, 128, 64}, {288, 160, 128, 144, 80},
    {320, 192, 160, 160, 96}, {352, 224, 192, 176, 112}, {384, 256, 224, 192, 128},
    {416, 320, 256, 224, 144}, {448, 384, 320, 256, 160}};

static const int kSampleRates[4][3] = {
    {11025, 12000, 8000},  // version 0: MPEG-2.5
    {0, 0, 0},             // version 1: reserved
    {22050, 24000, 16000}, // version 2: MPEG-2
    {44100, 48000, 32000}, // version 3: MPEG-1
};

// Long/short scalefactor band boundaries (ISO 11172-3 B.8 / 13818-3 B.2).
// Rate index: 0=44100 1=48000 2=32000 3=22050 4=24000 5=16000
//             6=11025 7=12000 8=8000  (MPEG-1 / -2 / -2.5 families).
static const int16_t kSfbLong[9][23] = {
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162, 196,
     238, 288, 342, 418, 576},
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128, 156, 190,
     230, 276, 330, 384, 576},
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156, 194, 240,
     296, 364, 448, 550, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194, 232,
     278, 332, 394, 464, 540, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},
    {0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232, 280, 336, 400,
     476, 566, 568, 570, 572, 574, 576}};

static const int16_t kSfbShort[9][14] = {
    {0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192},
    {0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192},
    {0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192},
    {0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},
    {0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192}};

// LSF nr_of_sfb per slen group: [category][block_kind long/short/mixed][4]
static const int8_t kLsfNr[3][3][4] = {
    {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
    {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
    {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}}};

// LSF nr_of_sfb, INTENSITY-channel (is_pos) layout — key scalefac_compress>>1
// (extracted from mpg123 bit-position probes, tests/test_intensity_lsf.py)
static const int8_t kLsfINr[3][3][4] = {
    {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
    {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
    {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}}};

// Implicit region1 boundary (lines) for window-switching granules:
// 3*short[3] for short blocks, long[8] for start/stop blocks.
static int ws_region1_lines(int block_type, int ridx) {
  if (block_type == 2) return kSfbShort[ridx][3] * 3;
  return kSfbLong[ridx][8];
}

static const int8_t kPretab[22] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0};

static const int8_t kSlen1[16] = {0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4};
static const int8_t kSlen2[16] = {0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3};

static int rate_idx(int sr) {
  switch (sr) {
    case 44100: return 0;
    case 48000: return 1;
    case 32000: return 2;
    case 22050: return 3;
    case 24000: return 4;
    case 16000: return 5;
    case 11025: return 6;
    case 12000: return 7;
    case 8000: return 8;
  }
  return -1;
}

// Short-block reorder permutations out = in[perm], keyed [rate][mixed].
static int16_t g_reorder[9][2][576];
static float g_is_ratio_a[8], g_is_ratio_b[8];  // intensity L/R factors
static std::once_flag g_init_flag;  // first ctypes calls can race (no GIL)

static void init_tables_impl() {
  for (int r = 0; r < 9; r++) {
    for (int mixed = 0; mixed < 2; mixed++) {
      int16_t* p = g_reorder[r][mixed];
      for (int i = 0; i < 576; i++) p[i] = (int16_t)i;
      for (int sfb = mixed ? 3 : 0; sfb < 13; sfb++) {
        int lo = kSfbShort[r][sfb], hi = kSfbShort[r][sfb + 1];
        int w_ = hi - lo, base = lo * 3;
        for (int i = 0; i < w_; i++)
          for (int w = 0; w < 3; w++)
            p[base + i * 3 + w] = (int16_t)(base + w * w_ + i);
      }
    }
  }
  for (int ip = 0; ip < 7; ip++) {
    double ratio = std::tan(ip * M_PI / 12.0);
    g_is_ratio_a[ip] = (float)(ratio / (1.0 + ratio));
    g_is_ratio_b[ip] = (float)(1.0 / (1.0 + ratio));
  }
}

static void init_tables() { std::call_once(g_init_flag, init_tables_impl); }

// ---------------------------------------------------------------------------
// Bit reader (MSB-first).  Reads past the end return zero bits; callers
// check `overrun()` at granule boundaries (overruns zero the whole frame,
// matching the Python front-end's exception path).
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* d;
  size_t nbytes;
  size_t pos = 0;  // bit position

  // Load a big-endian 64-bit window at the current byte; one unaligned
  // load + bswap on the fast path, byte-gather near the end of the buffer.
  inline uint64_t window(size_t byte) const {
    if (byte + 8 <= nbytes) {
      uint64_t w;
      memcpy(&w, d + byte, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
      w = __builtin_bswap64(w);
#endif
      return w;
    }
    uint64_t w = 0;
    for (int i = 0; i < 8; i++)
      w = (w << 8) | (byte + i < nbytes ? d[byte + i] : 0);
    return w;
  }
  inline uint32_t peek(int k) const {  // 0 <= k <= 24
    if (k == 0) return 0;  // k=0 would shift a u64 by 64 (UB)
    uint64_t w = window(pos >> 3);
    return (uint32_t)(w >> (64 - k - (pos & 7))) & ((1u << k) - 1);
  }
  inline uint32_t get(int k) {
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
  inline int get1() {
    size_t byte = pos >> 3;
    int v = byte < nbytes ? (d[byte] >> (7 - (pos & 7))) & 1 : 0;
    pos++;
    return v;
  }
  inline bool overrun() const { return pos > nbytes * 8; }
};

// ---------------------------------------------------------------------------
// Header / frame walk
// ---------------------------------------------------------------------------

struct Header {
  int version, layer, crc, bitrate, sr, padding, mode, mode_ext;
  int frame_len, channels;
};

static bool parse_header(uint32_t word, Header* h) {
  if (((word >> 21) & 0x7FF) != 0x7FF) return false;
  int version = (word >> 19) & 3;
  int layer = (word >> 17) & 3;
  int crc = !((word >> 16) & 1);
  int br_idx = (word >> 12) & 0xF;
  int sr_idx = (word >> 10) & 3;
  if (version == 1 || layer == 0 || br_idx == 15 || sr_idx == 3)
    return false;
  int sr = kSampleRates[version][sr_idx];
  int padding = (word >> 9) & 1;
  int bitrate;
  long slots;
  if (br_idx == 0) {
    // free format: the scanner measures frame length from sync spacing
    bitrate = 0;
    slots = 0;
  } else {
    int col;
    if (version == 3)
      col = (layer == 3) ? 0 : (layer == 2 ? 1 : 2);
    else
      col = (layer == 3) ? 3 : 4;
    bitrate = kBitrate[br_idx - 1][col] * 1000;
    if (layer == 1)  // Layer III
      slots = (long)(version == 3 ? 144 : 72) * bitrate / sr + padding;
    else if (layer == 2)  // Layer II
      slots = 144L * bitrate / sr + padding;
    else  // Layer I
      slots = (12L * bitrate / sr + padding) * 4;
  }
  h->version = version;
  h->layer = layer;
  h->crc = crc;
  h->bitrate = bitrate;
  h->sr = sr;
  h->padding = padding;
  h->mode = (word >> 6) & 3;
  h->mode_ext = (word >> 4) & 3;
  h->frame_len = (int)slots;
  h->channels = h->mode == 3 ? 1 : 2;
  return true;
}

struct Frame {
  int64_t pos;
  Header h;
};

// Xing/Info/VBRI metadata frame (first frame of VBR/LAME files): no audio.
static bool is_info_frame(const uint8_t* blob, int64_t n, int64_t pos,
                          const Header& h) {
  if (h.layer != 1) return false;  // Layer III streams only
  int64_t off = pos + 4 + (h.crc ? 2 : 0);
  int side = h.version == 3 ? (h.channels == 1 ? 17 : 32)
                            : (h.channels == 1 ? 9 : 17);
  if (off + side + 4 <= n) {
    const uint8_t* t = blob + off + side;
    if ((t[0] == 'X' && t[1] == 'i' && t[2] == 'n' && t[3] == 'g') ||
        (t[0] == 'I' && t[1] == 'n' && t[2] == 'f' && t[3] == 'o'))
      return true;
  }
  if (pos + 40 <= n) {
    const uint8_t* v = blob + pos + 36;
    if (v[0] == 'V' && v[1] == 'B' && v[2] == 'R' && v[3] == 'I') return true;
  }
  return false;
}

// Free format: measure base frame size from the next matching sync.
static int free_format_base(const uint8_t* blob, int64_t n, int64_t i,
                            const Header& h) {
  int step = h.layer != 3 ? 1 : 4;  // Layer I slots are 4 bytes
  for (int64_t j = i + 16; j + 4 <= n && j - i < 8192; j++) {
    if (blob[j] != 0xFF || (blob[j + 1] & 0xE0) != 0xE0) continue;
    uint32_t word = ((uint32_t)blob[j] << 24) | ((uint32_t)blob[j + 1] << 16) |
                    ((uint32_t)blob[j + 2] << 8) | blob[j + 3];
    Header h2;
    if (parse_header(word, &h2) && h2.bitrate == 0 &&
        h2.version == h.version && h2.layer == h.layer && h2.sr == h.sr) {
      return (int)(j - i) - h.padding * step;
    }
  }
  return 0;
}

// Scan bound with trailing metadata tags stripped: ID3v1 ("TAG", 128 B),
// ID3v1 Enhanced ("TAG+", 227 B before the ID3v1 tag), APEv2 (32-byte
// "APETAGEX" footer carrying the tag size) and Lyrics3v2 ("LYRICS200"
// end marker preceded by a 6-digit size).  Tags stack, so strip to a
// fixed point.  Exact mirror of frontend.scan_end (parity fuzzed).
static int64_t scan_end(const uint8_t* blob, int64_t n) {
  for (;;) {
    if (n >= 128 && blob[n - 128] == 'T' && blob[n - 127] == 'A' &&
        blob[n - 126] == 'G') {
      n -= 128;
      if (n >= 227 && blob[n - 227] == 'T' && blob[n - 226] == 'A' &&
          blob[n - 225] == 'G' && blob[n - 224] == '+')
        n -= 227;
      continue;
    }
    if (n >= 32 && memcmp(blob + n - 32, "APETAGEX", 8) == 0) {
      uint32_t size = (uint32_t)blob[n - 20] | ((uint32_t)blob[n - 19] << 8) |
                      ((uint32_t)blob[n - 18] << 16) |
                      ((uint32_t)blob[n - 17] << 24);
      uint32_t flags = (uint32_t)blob[n - 12] | ((uint32_t)blob[n - 11] << 8) |
                       ((uint32_t)blob[n - 10] << 16) |
                       ((uint32_t)blob[n - 9] << 24);
      int64_t total = (int64_t)size + ((flags & 0x80000000u) ? 32 : 0);
      if (total >= 32 && total <= n) {
        n -= total;
        continue;
      }
    }
    if (n >= 15 && memcmp(blob + n - 9, "LYRICS200", 9) == 0) {
      bool digits = true;
      int64_t sz = 0;
      for (int k = 0; k < 6; k++) {
        uint8_t c = blob[n - 15 + k];
        if (c < '0' || c > '9') { digits = false; break; }
        sz = sz * 10 + (c - '0');
      }
      if (digits && sz + 15 <= n) {
        n -= sz + 15;
        continue;
      }
    }
    return n;
  }
}

// Sequential sync walk with resync-on-junk (robust form of mpeg.rs:17-121).
// A leading ID3v2 tag (synchsafe size), trailing ID3v1/APE/Lyrics3 tags,
// and a leading Xing/Info/VBRI metadata frame are skipped; free-format
// frame lengths are measured.
// Total find_frames invocations — exported for tests that pin the
// single-walk contract of the session API (one walk per blob).
static std::atomic<int64_t> g_frame_walks{0};

static void find_frames(const uint8_t* blob, int64_t n, std::vector<Frame>* out) {
  g_frame_walks.fetch_add(1, std::memory_order_relaxed);
  n = scan_end(blob, n);
  int64_t i = 0;
  if (n >= 10 && blob[0] == 'I' && blob[1] == 'D' && blob[2] == '3') {
    int64_t size = ((int64_t)(blob[6] & 0x7F) << 21) |
                   ((int64_t)(blob[7] & 0x7F) << 14) |
                   ((int64_t)(blob[8] & 0x7F) << 7) | (blob[9] & 0x7F);
    i = 10 + size;
  }
  int free_base = 0;
  while (i + 4 <= n) {
    if (blob[i] == 0xFF && (blob[i + 1] & 0xE0) == 0xE0) {
      uint32_t word = ((uint32_t)blob[i] << 24) | ((uint32_t)blob[i + 1] << 16) |
                      ((uint32_t)blob[i + 2] << 8) | blob[i + 3];
      Header h;
      if (parse_header(word, &h)) {
        if (h.bitrate == 0) {
          if (!free_base) free_base = free_format_base(blob, n, i, h);
          if (free_base)
            h.frame_len = free_base + h.padding * (h.layer != 3 ? 1 : 4);
        }
        if (h.frame_len > 0 && i + h.frame_len <= n) {
          if (!out->empty() || !is_info_frame(blob, n, i, h)) {
            out->push_back({i, h});
          }
          i += h.frame_len;
          continue;
        }
      }
    }
    i++;
  }
}

// ---------------------------------------------------------------------------
// Side info / scalefactors / Huffman
// ---------------------------------------------------------------------------

struct Granule {
  int part2_3_length, big_values, global_gain, scalefac_compress;
  int window_switching, block_type, mixed;
  int table_select[3], subblock_gain[3];
  int region0_count, region1_count;
  int preflag, scalefac_scale, count1table_select;
};

struct SideInfo {
  int main_data_begin;
  int ngr;
  int scfsi[2][4];
  Granule gr[2][2];  // [granule][channel]
};

static void read_side_info(BitReader* b, int channels, SideInfo* si,
                           int version = 3) {
  bool lsf = version != 3;
  si->main_data_begin = b->get(lsf ? 8 : 9);
  if (lsf) {
    b->get(channels == 1 ? 1 : 2);  // private bits
    memset(si->scfsi, 0, sizeof(si->scfsi));
    si->ngr = 1;
  } else {
    b->get(channels == 1 ? 5 : 3);  // private bits
    for (int c = 0; c < channels; c++)
      for (int i = 0; i < 4; i++) si->scfsi[c][i] = b->get1();
    si->ngr = 2;
  }
  for (int gr = 0; gr < si->ngr; gr++) {
    for (int c = 0; c < channels; c++) {
      Granule* g = &si->gr[gr][c];
      g->part2_3_length = b->get(12);
      g->big_values = b->get(9);
      g->global_gain = b->get(8);
      g->scalefac_compress = b->get(lsf ? 9 : 4);
      g->window_switching = b->get1();
      if (g->window_switching) {
        g->block_type = b->get(2);
        g->mixed = b->get1();
        g->table_select[0] = b->get(5);
        g->table_select[1] = b->get(5);
        g->table_select[2] = 0;
        for (int w = 0; w < 3; w++) g->subblock_gain[w] = b->get(3);
        g->region0_count = 7;
        g->region1_count = 36;
      } else {
        g->block_type = 0;
        g->mixed = 0;
        for (int r = 0; r < 3; r++) g->table_select[r] = b->get(5);
        for (int w = 0; w < 3; w++) g->subblock_gain[w] = 0;
        g->region0_count = b->get(4);
        g->region1_count = b->get(3);
      }
      // LSF has no preflag bit — it derives from scalefac_compress
      g->preflag = lsf ? 0 : b->get1();
      g->scalefac_scale = b->get1();
      g->count1table_select = b->get1();
    }
  }
}

struct Scalefacs {
  int32_t l[23];
  int32_t s[13][3];
};

// Shared LSF expansion: read four slen-bit groups per the nr table row
// and fan them out into long/short/mixed scalefactor slots.
static void lsf_expand_scalefacs(BitReader* b, const int8_t* nr /*[4]*/,
                                 const int slen[4], int kind, Scalefacs* sf) {
  int seq[40];
  int n = 0;
  for (int k = 0; k < 4; k++)
    for (int j = 0; j < nr[k]; j++)
      seq[n++] = slen[k] ? (int)b->get(slen[k]) : 0;
  int i = 0;
  if (kind == 0) {
    for (int sfb = 0; sfb < 21; sfb++) sf->l[sfb] = seq[i++];
  } else if (kind == 1) {
    for (int sfb = 0; sfb < 12; sfb++)
      for (int w = 0; w < 3; w++) sf->s[sfb][w] = seq[i++];
  } else {
    for (int sfb = 0; sfb < 6; sfb++) sf->l[sfb] = seq[i++];
    for (int sfb = 3; sfb < 12; sfb++)
      for (int w = 0; w < 3; w++) sf->s[sfb][w] = seq[i++];
  }
}

// LSF scalefactors (ISO 13818-3 2.4.3.2): four groups of nr_of_sfb values
// at slen bits each; sets g->preflag from the category.  The intensity-
// coded channel (i_stereo) uses the is_pos layout keyed by sc >> 1.
static void read_scalefacs_lsf(BitReader* b, Granule* g, Scalefacs* sf,
                               bool i_stereo = false) {
  memset(sf, 0, sizeof(*sf));
  int sc = g->scalefac_compress;
  int slen[4], cat;
  bool short_blk = g->window_switching && g->block_type == 2;
  int kind = short_blk ? (g->mixed ? 2 : 1) : 0;
  if (i_stereo) {
    int isc = sc >> 1;
    if (isc < 180) {
      slen[0] = isc / 36;
      slen[1] = (isc % 36) / 6;
      slen[2] = isc % 6;
      slen[3] = 0;
      cat = 0;
    } else if (isc < 244) {
      int s = isc - 180;
      slen[0] = (s >> 4) & 3;
      slen[1] = (s >> 2) & 3;
      slen[2] = s & 3;
      slen[3] = 0;
      cat = 1;
    } else {
      int s = isc - 244;
      slen[0] = s / 3;
      slen[1] = s % 3;
      slen[2] = 0;
      slen[3] = 0;
      cat = 2;
    }
    g->preflag = 0;
    lsf_expand_scalefacs(b, kLsfINr[cat][kind], slen, kind, sf);
    return;
  }
  if (sc < 400) {
    slen[0] = (sc >> 4) / 5;
    slen[1] = (sc >> 4) % 5;
    slen[2] = (sc % 16) >> 2;
    slen[3] = sc % 4;
    cat = 0;
    g->preflag = 0;
  } else if (sc < 500) {
    int s = sc - 400;
    slen[0] = (s >> 2) / 5;
    slen[1] = (s >> 2) % 5;
    slen[2] = s % 4;
    slen[3] = 0;
    cat = 1;
    g->preflag = 0;
  } else {
    int s = sc - 500;
    slen[0] = s / 3;
    slen[1] = s % 3;
    slen[2] = 0;
    slen[3] = 0;
    cat = 2;
    g->preflag = 1;
  }
  lsf_expand_scalefacs(b, kLsfNr[cat][kind], slen, kind, sf);
}

static void read_scalefacs(BitReader* b, const Granule* g, int gr,
                           const int* scfsi, const Scalefacs* prev,
                           Scalefacs* sf) {
  memset(sf, 0, sizeof(*sf));
  int slen1 = kSlen1[g->scalefac_compress];
  int slen2 = kSlen2[g->scalefac_compress];
  bool short_blk = g->window_switching && g->block_type == 2;
  if (short_blk && !g->mixed) {
    for (int sfb = 0; sfb < 6; sfb++)
      for (int w = 0; w < 3; w++) sf->s[sfb][w] = b->get(slen1);
    for (int sfb = 6; sfb < 12; sfb++)
      for (int w = 0; w < 3; w++) sf->s[sfb][w] = b->get(slen2);
  } else if (short_blk && g->mixed) {
    for (int sfb = 0; sfb < 8; sfb++) sf->l[sfb] = b->get(slen1);
    for (int sfb = 3; sfb < 6; sfb++)
      for (int w = 0; w < 3; w++) sf->s[sfb][w] = b->get(slen1);
    for (int sfb = 6; sfb < 12; sfb++)
      for (int w = 0; w < 3; w++) sf->s[sfb][w] = b->get(slen2);
  } else {
    static const int groups[4][3] = {
        {0, 6, 0}, {6, 11, 0}, {11, 16, 1}, {16, 21, 1}};
    for (int gi = 0; gi < 4; gi++) {
      int lo = groups[gi][0], hi = groups[gi][1];
      int sl = groups[gi][2] ? slen2 : slen1;
      if (gr == 1 && scfsi[gi] && prev) {
        for (int sfb = lo; sfb < hi; sfb++) sf->l[sfb] = prev->l[sfb];
      } else {
        for (int sfb = lo; sfb < hi; sfb++) sf->l[sfb] = b->get(sl);
      }
    }
  }
}

// Decode the 576-line quantized spectrum.  Returns false on a reserved
// table select (frame is zeroed by the caller).
static bool huffman_spectrum(BitReader* b, const Granule* g, int ridx,
                             size_t part2_start, int32_t* is_) {
  memset(is_, 0, 576 * sizeof(int32_t));
  int region1, region2;
  if (g->window_switching) {
    region1 = ws_region1_lines(g->block_type, ridx);
    region2 = 576;
  } else {
    const int16_t* bands = kSfbLong[ridx];
    region1 = bands[g->region0_count + 1];
    int r2 = g->region0_count + g->region1_count + 2;
    region2 = bands[r2 > 22 ? 22 : r2];
  }
  int big = 2 * g->big_values;
  int idx = 0;
  while (idx < big) {
    int region = idx < region1 ? 0 : (idx < region2 ? 1 : 2);
    int tsel = g->table_select[region];
    int tid = kTableId[tsel];
    if (tid < 0) return false;
    int x = 0, y = 0;
    if (tid != 0) {
      const BigLut bl = kBigLuts[tid];
      uint16_t e = bl.lut[b->peek(bl.bits)];
      int len = e >> 8;
      if (len == 0) return false;  // invalid code
      b->pos += len;
      x = (e >> 4) & 15;
      y = e & 15;
      int linbits = kLinbits[tsel];
      if (x == 15 && linbits) x += b->get(linbits);
      if (x && b->get1()) x = -x;
      if (y == 15 && linbits) y += b->get(linbits);
      if (y && b->get1()) y = -y;
    }
    if (idx < 576) is_[idx] = x;
    if (idx + 1 < 576) is_[idx + 1] = y;
    idx += 2;
  }
  const uint16_t* c1 = kCount1Luts[g->count1table_select];
  size_t end = part2_start + g->part2_3_length;
  while (b->pos < end && idx < 576) {
    uint16_t e = c1[b->peek(6)];
    int len = e >> 4;
    if (len == 0) return false;
    b->pos += len;
    int v = e & 15;
    for (int q = 3; q >= 0 && idx < 576; q--) {
      int bit = (v >> q) & 1;
      if (bit && b->get1()) bit = -bit;
      is_[idx++] = bit;
    }
  }
  if (b->pos > end) {  // quad straddling the boundary is discarded
    for (int i = idx - 4 < 0 ? 0 : idx - 4; i < idx; i++) is_[i] = 0;
  }
  b->pos = end;
  return true;
}

// Per-band 4x requantizer exponent (exact integer), 61 slots:
// 0..21 long sfb, 22 + sfb*3 + w short.  The device expands per line
// through a static line->band map and computes gain = 2^(e/4).
static void compute_exp_bands(const Granule* g, const Scalefacs* sf,
                              int16_t* e /*[61]*/, int version = 3) {
  memset(e, 0, 61 * sizeof(int16_t));
  int gg = g->global_gain - 210;
  int sf_mult4 = 2 * (1 + g->scalefac_scale);  // 4 * sf_mult
  bool short_blk = g->window_switching && g->block_type == 2;
  if (!short_blk || g->mixed) {
    // mixed long region: 8 sfbs (MPEG-1) / 6 sfbs (LSF), both to line 36
    int hi_sfb = short_blk ? (version == 3 ? 8 : 6) : 22;
    for (int sfb = 0; sfb < hi_sfb; sfb++)
      e[sfb] = (int16_t)(gg - sf_mult4 * (sf->l[sfb] + g->preflag * kPretab[sfb]));
  }
  if (short_blk) {
    for (int sfb = g->mixed ? 3 : 0; sfb < 13; sfb++)
      for (int w = 0; w < 3; w++)
        e[22 + sfb * 3 + w] = (int16_t)((gg - 8 * g->subblock_gain[w]) -
                                        sf_mult4 * sf->s[sfb][w]);
  }
}

// Per-line stereo mode byte (0 LR, 1 MS, 2+k MPEG-1 intensity is_pos k,
// 18 + scale*32 + k LSF intensity) — mirror of frontend._stereo_modes;
// the device LUT expands to mixing planes.
static void stereo_modes(const int32_t* is_l, const int32_t* is_r,
                         const Granule* g_r, const Scalefacs* sf_r,
                         const Header* h, int ridx, bool lsf,
                         int8_t* modes /*[576]*/) {
  memset(modes, 0, 576);
  if (h->mode != 1) return;
  bool ms = h->mode_ext & 2;
  bool intensity = h->mode_ext & 1;
  int i_scale = g_r->scalefac_compress & 1;
  auto set_ms = [&](int lo, int hi) {
    for (int i = lo; i < hi; i++) modes[i] = 1;
  };
  auto mode_of = [&](int is_pos) {
    if (lsf) return (int8_t)(18 + i_scale * 32 + (is_pos < 31 ? is_pos : 31));
    return (int8_t)(2 + (is_pos < 15 ? is_pos : 15));
  };
  auto set_is = [&](int lo, int hi, int is_pos) {
    if (is_pos == 7) {
      if (ms) set_ms(lo, hi);
      return;
    }
    int8_t m = mode_of(is_pos);
    for (int i = lo; i < hi; i++) modes[i] = m;
  };
  if (!intensity) {
    if (ms) set_ms(0, 576);
    return;
  }
  bool short_blk = g_r->window_switching && g_r->block_type == 2;
  bool mixed = short_blk && g_r->mixed;
  const int16_t* lb = kSfbLong[ridx];
  const int16_t* sb = kSfbShort[ridx];
  int bound_line = 0;
  if (!short_blk || mixed) {
    // bound from the GLOBAL last nonzero: in mixed blocks any
    // short-region content pushes it past the whole long part
    int rzero = 0;
    for (int i = 575; i >= 0; i--)
      if (is_r[i]) { rzero = i + 1; break; }
    int n_long = mixed ? (lsf ? 6 : 8) : 22;
    int bound_sfb = 21;
    while (bound_sfb > 0 && lb[bound_sfb] >= rzero) bound_sfb--;
    bound_sfb++;
    if (rzero == 0) bound_sfb = 0;  // fully empty right: band 0 included
    if (bound_sfb > n_long) bound_sfb = n_long;
    for (int sfb = bound_sfb; sfb < n_long; sfb++) {
      int is_pos = sfb < 21 ? sf_r->l[sfb < 20 ? sfb : 20] : 7;
      set_is(lb[sfb], lb[sfb + 1], is_pos);
    }
    bound_line = lb[bound_sfb];
  }
  if (short_blk) {
    // short blocks: per-window bound past the window's last nonzero;
    // segments are strided in reordered line space (pinned to mpg123
    // via crafted streams, tests/test_intensity*.py); mixed blocks only
    // have short bands from sfb 3 (lines >= 36)
    int first_sfb = mixed ? 3 : 0;
    for (int w = 0; w < 3; w++) {
      int bound_w = 0;
      for (int sfb = 0; sfb < 13; sfb++) {
        for (int j = sb[sfb] * 3 + w; j < sb[sfb + 1] * 3; j += 3)
          if (is_r[j]) { bound_w = sfb + 1; break; }
      }
      for (int sfb = first_sfb; sfb < 13; sfb++) {
        int is_pos = sf_r->s[sfb < 11 ? sfb : 11][w];
        for (int j = sb[sfb] * 3 + w; j < sb[sfb + 1] * 3; j += 3) {
          if (sfb >= bound_w) {
            if (is_pos == 7) {
              if (ms) modes[j] = 1;
            } else {
              modes[j] = mode_of(is_pos);
            }
          } else if (ms) {
            modes[j] = 1;
          }
        }
      }
    }
    if (!mixed) return;
  }
  if (ms) set_ms(0, bound_line);
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

typedef struct {
  int32_t sample_rate;
  int32_t channels;
  int32_t n_granules;
  int32_t joint;       // any frame joint-stereo
  int32_t err;         // 0 ok, 3 invalid (no MPEG-1 L3 frames)
  int32_t main_bytes;  // total concatenated main_data bytes
} mp3fe_info;

// Geometry summary over an already-collected frame list (no walk).
static void probe_from_frames(const std::vector<Frame>& frames,
                              mp3fe_info* info) {
  memset(info, 0, sizeof(*info));
  int sr = 0, ch = 0, ver = -1, count = 0, joint = 0;
  int64_t main_bytes = 0;
  for (const Frame& f : frames) {
    if (f.h.layer != 1) continue;  // Layer III only (any MPEG version)
    if (!sr) { sr = f.h.sr; ch = f.h.channels; ver = f.h.version; }
    if (f.h.sr != sr || f.h.channels != ch || f.h.version != ver) continue;
    count++;
    if (f.h.mode == 1) joint = 1;
    int side_len = ver == 3 ? (ch == 1 ? 17 : 32) : (ch == 1 ? 9 : 17);
    int64_t off = f.pos + 4 + (f.h.crc ? 2 : 0);
    int64_t ml = f.pos + f.h.frame_len - (off + side_len);
    if (ml > 0) main_bytes += ml;
  }
  if (!count) { info->err = 3; return; }
  info->sample_rate = sr;
  info->channels = ch;
  info->n_granules = (ver == 3 ? 2 : 1) * count;
  info->joint = joint;
  info->main_bytes = (int32_t)main_bytes;
}

// Phase 1: cheap frame walk — geometry only (no entropy decode).
void mp3fe_probe(const uint8_t* blob, int64_t n, mp3fe_info* info) {
  init_tables();
  std::vector<Frame> frames;
  find_frames(blob, n, &frames);
  probe_from_frames(frames, info);
}

// Phase 2: full analysis into caller-allocated dense tensors:
//   is_q  int16 [Gcap, ch, 576]     exp_b int16 [Gcap, ch, 61]
//   st    int8  [Gcap, 576]         (stereo mode bytes; may be null)
//   cfg   int8  [Gcap, ch]          (block_type | mixed<<2)
// Buffers must be zero-initialized by the caller (silent-granule padding).
void mp3fe_analyze(const uint8_t* blob, int64_t n, int32_t g_cap,
                   int16_t* is_out, int16_t* expb_out, int8_t* st_out,
                   int8_t* cfg_out, mp3fe_info* info) {
  init_tables();
  mp3fe_probe(blob, n, info);
  if (info->err) return;
  int sr = info->sample_rate, ch = info->channels;
  int ridx = rate_idx(sr);
  if (ridx < 0) { info->err = 3; return; }

  std::vector<Frame> frames;
  find_frames(blob, n, &frames);

  std::vector<uint8_t> reservoir;
  reservoir.reserve(8192);
  std::vector<uint8_t> data;
  data.reserve(8192);

  int32_t is_tmp[2][2][576];
  int16_t eb_tmp[2][2][61];
  Scalefacs sf_store[2][2];

  int ver = ridx < 3 ? 3 : (ridx < 6 ? 2 : 0);  // rate family ⇒ version
  int ngr = ver == 3 ? 2 : 1;
  Granule* gmut;
  int fi = 0;
  for (const Frame& f : frames) {
    if (f.h.layer != 1) continue;
    if (f.h.sr != sr || f.h.channels != ch) continue;
    int gbase = ngr * fi;
    fi++;
    if (gbase + ngr > g_cap) break;

    int side_len = ver == 3 ? (ch == 1 ? 17 : 32) : (ch == 1 ? 9 : 17);
    int64_t off = f.pos + 4 + (f.h.crc ? 2 : 0);
    const uint8_t* main = blob + off + side_len;
    int64_t main_len = f.pos + f.h.frame_len - (off + side_len);
    if (main_len < 0) main_len = 0;

    auto push_reservoir = [&]() {
      reservoir.insert(reservoir.end(), main, main + main_len);
      if (reservoir.size() > 4096)
        reservoir.erase(reservoir.begin(),
                        reservoir.begin() + (reservoir.size() - 4096));
    };

    if (off + side_len > n) { push_reservoir(); continue; }
    BitReader sb{blob + off, (size_t)side_len, 0};
    SideInfo si;
    read_side_info(&sb, ch, &si, ver);

    int64_t start = (int64_t)reservoir.size() - si.main_data_begin;
    if (start < 0) { push_reservoir(); continue; }  // silent frame

    data.assign(reservoir.begin() + start, reservoir.end());
    data.insert(data.end(), main, main + main_len);
    BitReader b{data.data(), data.size(), 0};

    bool ok = true;
    const Scalefacs* prev[2] = {nullptr, nullptr};
    for (int gr = 0; gr < ngr && ok; gr++) {
      for (int c = 0; c < ch && ok; c++) {
        gmut = &si.gr[gr][c];
        const Granule* g = gmut;
        size_t part2_start = b.pos;
        Scalefacs* sf = &sf_store[gr][c];
        bool i_st = c == 1 && f.h.mode == 1 && (f.h.mode_ext & 1);
        if (ver == 3)
          read_scalefacs(&b, g, gr, si.scfsi[c], prev[c], sf);
        else
          read_scalefacs_lsf(&b, gmut, sf, i_st);  // sets preflag
        // a scalefactor walk past the data window (possible on corrupt
        // streams whose part2_3_length under-claims the scalefactor
        // bits) reads zero bits — the Python reference raises there, so
        // match it by invalidating instead of emitting garbage lanes
        if (b.overrun()) { ok = false; break; }
        prev[c] = sf;
        if (!huffman_spectrum(&b, g, ridx, part2_start, is_tmp[gr][c])) {
          ok = false;
          break;
        }
        compute_exp_bands(g, sf, eb_tmp[gr][c], ver);
        if (g->window_switching && g->block_type == 2) {
          const int16_t* perm = g_reorder[ridx][g->mixed ? 1 : 0];
          int32_t ti[576];
          for (int i = 0; i < 576; i++) ti[i] = is_tmp[gr][c][perm[i]];
          memcpy(is_tmp[gr][c], ti, sizeof(ti));
        }
        if (b.overrun()) { ok = false; break; }
      }
    }
    if (ok) {
      for (int gr = 0; gr < ngr; gr++) {
        int64_t gi = gbase + gr;
        for (int c = 0; c < ch; c++) {
          int16_t* dst_is = is_out + (gi * ch + c) * 576;
          for (int i = 0; i < 576; i++) dst_is[i] = (int16_t)is_tmp[gr][c][i];
          memcpy(expb_out + (gi * ch + c) * 61, eb_tmp[gr][c],
                 61 * sizeof(int16_t));
          const Granule* g = &si.gr[gr][c];
          cfg_out[gi * ch + c] = (int8_t)(g->block_type | (g->mixed << 2));
        }
        if (st_out && ch == 2) {
          stereo_modes(is_tmp[gr][0], is_tmp[gr][1], &si.gr[gr][1],
                       &sf_store[gr][1], &f.h, ridx, ver != 3,
                       st_out + gi * 576);
        }
      }
    }
    // !ok: frame granules stay zero (caller pre-zeroed the buffers)
    push_reservoir();
  }
}

// Lane-metadata analysis for ON-DEVICE Huffman decode: the host parses
// only headers, side info and scalefactors; the raw concatenated
// main_data plus per-granule-channel bit windows go to the device
// (dsp.mp3_decode_fused).  Output contract mirrors frontend.analyze_lanes.
//
// Caller-allocated, zero-initialized outputs (Gcap granules, ch channels):
//   main  uint8 [Mcap]               start/end/limit int32 [Gcap, ch]
//   big/r1/r2 int16 [Gcap, ch]       tsel int8 [Gcap, ch, 3]
//   c1sel/valid/cfg int8 [Gcap, ch]  exp_b int16 [Gcap, ch, 61]
//   stflags int8 [Gcap]              sfr int8 [Gcap, 61]
static void lanes_from_frames(const uint8_t* blob, int64_t n,
                              const std::vector<Frame>& frames,
                              int32_t g_cap, int64_t m_cap,
                              uint8_t* main_out, int32_t* start_out,
                              int32_t* end_out, int32_t* limit_out,
                              int16_t* big_out, int16_t* r1_out,
                              int16_t* r2_out, int8_t* tsel_out,
                              int8_t* c1_out, int8_t* valid_out,
                              int16_t* expb_out, int8_t* cfg_out,
                              int8_t* stflags_out, int8_t* sfr_out,
                              mp3fe_info* info) {
  // `info` carries the probe summary for these same frames; the caller
  // has already rejected err != 0
  int sr = info->sample_rate, ch = info->channels;
  int ridx = rate_idx(sr);
  if (ridx < 0) { info->err = 3; return; }

  int64_t total_main = 0;  // bytes appended to main_out so far
  Scalefacs sf_store[2][2];
  int ver = ridx < 3 ? 3 : (ridx < 6 ? 2 : 0);  // rate family ⇒ version
  int ngr = ver == 3 ? 2 : 1;
  int fi = 0;
  for (const Frame& f : frames) {
    if (f.h.layer != 1) continue;
    if (f.h.sr != sr || f.h.channels != ch) continue;
    int gbase = ngr * fi;
    fi++;
    if (gbase + ngr > g_cap) break;

    int side_len = ver == 3 ? (ch == 1 ? 17 : 32) : (ch == 1 ? 9 : 17);
    int64_t off = f.pos + 4 + (f.h.crc ? 2 : 0);
    const uint8_t* main = blob + off + side_len;
    int64_t main_len = f.pos + f.h.frame_len - (off + side_len);
    if (main_len < 0) main_len = 0;
    if (total_main + main_len > m_cap) break;

    auto append_main = [&]() {
      memcpy(main_out + total_main, main, main_len);
      total_main += main_len;
    };

    if (off + side_len > n) { append_main(); continue; }
    BitReader sb{blob + off, (size_t)side_len, 0};
    SideInfo si;
    read_side_info(&sb, ch, &si, ver);

    int64_t start_byte_abs = total_main - si.main_data_begin;
    if (start_byte_abs < 0) { append_main(); continue; }
    // Data window = main_out[start_byte_abs .. total_main) + this main.
    int64_t data_bytes = (total_main - start_byte_abs) + main_len;
    int64_t limit = (start_byte_abs + data_bytes) * 8;
    int64_t base_bits = start_byte_abs * 8;

    // Scalefactor walk over the logical window: reads never cross the
    // reservoir/main boundary mid-field unsafely, so use a small local
    // concat buffer (cheap: <= ~2 KB).
    static thread_local std::vector<uint8_t> data;
    data.assign(main_out + start_byte_abs, main_out + total_main);
    data.insert(data.end(), main, main + main_len);
    BitReader b{data.data(), data.size(), 0};

    bool ok = true;
    const Scalefacs* prev[2] = {nullptr, nullptr};
    for (int gr = 0; gr < ngr && ok; gr++) {
      for (int c = 0; c < ch && ok; c++) {
        Granule* gmut = &si.gr[gr][c];
        const Granule* g = gmut;
        size_t part2_rel = b.pos;
        size_t end_rel = part2_rel + g->part2_3_length;
        if (end_rel > data.size() * 8) { ok = false; break; }
        Scalefacs* sf = &sf_store[gr][c];
        bool i_st = c == 1 && f.h.mode == 1 && (f.h.mode_ext & 1);
        if (ver == 3)
          read_scalefacs(&b, g, gr, si.scfsi[c], prev[c], sf);
        else
          read_scalefacs_lsf(&b, gmut, sf, i_st);  // sets preflag
        // a scalefactor walk past the data window (possible on corrupt
        // streams whose part2_3_length under-claims the scalefactor
        // bits) reads zero bits — the Python reference raises there, so
        // match it by invalidating instead of emitting garbage lanes
        if (b.overrun()) { ok = false; break; }
        prev[c] = sf;
        int64_t gi = gbase + gr;
        int64_t li = gi * ch + c;
        start_out[li] = (int32_t)(base_bits + b.pos);
        end_out[li] = (int32_t)(base_bits + end_rel);
        limit_out[li] = (int32_t)limit;
        big_out[li] = (int16_t)g->big_values;
        if (g->window_switching) {
          r1_out[li] = (int16_t)ws_region1_lines(g->block_type, ridx);
          r2_out[li] = 576;
        } else {
          const int16_t* bands = kSfbLong[ridx];
          r1_out[li] = bands[g->region0_count + 1];
          int r2 = g->region0_count + g->region1_count + 2;
          r2_out[li] = bands[r2 > 22 ? 22 : r2];
        }
        for (int rg = 0; rg < 3; rg++)
          tsel_out[li * 3 + rg] = (int8_t)g->table_select[rg];
        c1_out[li] = (int8_t)g->count1table_select;
        compute_exp_bands(g, sf, expb_out + li * 61, ver);
        cfg_out[li] = (int8_t)(g->block_type | (g->mixed << 2));
        valid_out[li] = 1;
        if (c == ch - 1) {
          stflags_out[gi] = (int8_t)(
              (f.h.mode == 1 ? 1 : 0) | (f.h.mode_ext & 2) |
              ((f.h.mode_ext & 1) << 2) |
              ((ver != 3 && i_st) ? (g->scalefac_compress & 1) << 3 : 0));
          if (ch == 2) {
            for (int sfb = 0; sfb < 22; sfb++)
              sfr_out[gi * 61 + sfb] = (int8_t)sf->l[sfb];
            for (int sfb = 0; sfb < 13; sfb++)
              for (int w = 0; w < 3; w++)
                sfr_out[gi * 61 + 22 + sfb * 3 + w] = (int8_t)sf->s[sfb][w];
          }
        }
        b.pos = end_rel;  // jump over the Huffman region
      }
    }
    if (!ok) {
      for (int gi = gbase; gi < gbase + ngr; gi++)
        for (int c = 0; c < ch; c++) valid_out[gi * ch + c] = 0;
    }
    append_main();
  }
  info->main_bytes = (int32_t)total_main;
}

void mp3fe_lanes(const uint8_t* blob, int64_t n, int32_t g_cap, int64_t m_cap,
                 uint8_t* main_out, int32_t* start_out, int32_t* end_out,
                 int32_t* limit_out, int16_t* big_out, int16_t* r1_out,
                 int16_t* r2_out, int8_t* tsel_out, int8_t* c1_out,
                 int8_t* valid_out, int16_t* expb_out, int8_t* cfg_out,
                 int8_t* stflags_out, int8_t* sfr_out, mp3fe_info* info) {
  init_tables();
  std::vector<Frame> frames;
  find_frames(blob, n, &frames);
  probe_from_frames(frames, info);
  if (info->err) return;
  lanes_from_frames(blob, n, frames, g_cap, m_cap, main_out, start_out,
                    end_out, limit_out, big_out, r1_out, r2_out, tsel_out,
                    c1_out, valid_out, expb_out, cfg_out, stflags_out,
                    sfr_out, info);
}

// Batched lane analysis, threaded over files; outputs strided [B, ...].
void mp3fe_lanes_batch(const uint8_t* const* blobs, const int64_t* lens,
                       int32_t nfiles, int32_t g_cap, int64_t m_cap,
                       int32_t channels, uint8_t* main_out,
                       int32_t* start_out, int32_t* end_out,
                       int32_t* limit_out, int16_t* big_out, int16_t* r1_out,
                       int16_t* r2_out, int8_t* tsel_out, int8_t* c1_out,
                       int8_t* valid_out, int16_t* expb_out, int8_t* cfg_out,
                       int8_t* stflags_out, int8_t* sfr_out,
                       mp3fe_info* infos, int32_t nthreads) {
  init_tables();
  if (nthreads <= 0) {
    nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  if (nthreads > nfiles) nthreads = nfiles;
  std::atomic<int32_t> next(0);
  int64_t L = (int64_t)g_cap * channels;
  auto worker = [&]() {
    for (;;) {
      int32_t b = next.fetch_add(1);
      if (b >= nfiles) return;
      // the output strides assume the caller's channel count; a blob
      // whose real channel count differs would write out of bounds —
      // probe first and fail the file instead (InvalidData)
      mp3fe_probe(blobs[b], lens[b], infos + b);
      if (infos[b].err == 0 && infos[b].channels != channels) {
        infos[b].err = 3;
        continue;
      }
      if (infos[b].err != 0) continue;
      mp3fe_lanes(blobs[b], lens[b], g_cap, m_cap, main_out + b * m_cap,
                  start_out + b * L, end_out + b * L, limit_out + b * L,
                  big_out + b * L, r1_out + b * L, r2_out + b * L,
                  tsel_out + b * L * 3, c1_out + b * L, valid_out + b * L,
                  expb_out + b * L * 61, cfg_out + b * L,
                  stflags_out + b * g_cap, sfr_out + b * g_cap * 61,
                  infos + b);
    }
  };
  if (nthreads == 1) { worker(); return; }
  std::vector<std::thread> ts;
  for (int i = 0; i < nthreads; i++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// Batched analysis: one uniform (channels, joint) group, threaded over files.
// Outputs are [B, Gcap, ...] contiguous; st_out may be null.
void mp3fe_analyze_batch(const uint8_t* const* blobs, const int64_t* lens,
                         int32_t nfiles, int32_t g_cap, int32_t channels,
                         int16_t* is_out, int16_t* expb_out, int8_t* st_out,
                         int8_t* cfg_out, mp3fe_info* infos,
                         int32_t nthreads) {
  init_tables();
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
      // see lanes_batch: reject channel-count mismatches before writing
      mp3fe_probe(blobs[b], lens[b], infos + b);
      if (infos[b].err == 0 && infos[b].channels != channels) {
        infos[b].err = 3;
        continue;
      }
      if (infos[b].err != 0) continue;
      int64_t gstride = (int64_t)g_cap;
      mp3fe_analyze(
          blobs[b], lens[b], g_cap,
          is_out + b * gstride * channels * 576,
          expb_out + b * gstride * channels * 61,
          st_out ? st_out + b * gstride * 576 : nullptr,
          cfg_out + b * gstride * channels,
          infos + b);
    }
  };
  if (nthreads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> ts;
  for (int i = 0; i < nthreads; i++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Session API — ONE frame walk per blob.
//
// The classic entry points above re-walk each blob (probe for grouping,
// the batch drivers' channel guard, the lane emitter) — up to 3 walks per
// blob per decode.  A session walks every blob exactly once at open time,
// stores the frame tables, and feeds grouping (probe infos + routed
// layer), the channel guard, and lane emission from that single walk —
// the shape of the reference's single pass (mpeg.rs:7-128).  The caller
// owns blob lifetime for the session's duration.
// ---------------------------------------------------------------------------

struct mp3fe_session {
  std::vector<const uint8_t*> blobs;
  std::vector<int64_t> lens;
  std::vector<std::vector<Frame>> frames;
  std::vector<mp3fe_info> infos;
};

// Cumulative find_frames invocations (process-wide) — lets tests pin the
// "one walk per blob" contract as a hard counter delta.
int64_t mp3fe_frame_walks(void) {
  return g_frame_walks.load(std::memory_order_relaxed);
}

// Walk + probe every blob once (threaded).  infos_out[b] gets the Layer
// III geometry summary; layers_out[b] gets the routed layer of the FIRST
// frame in human numbering (1/2/3; 0 = no frame found) for front-end
// dispatch (Layer I/II take the subband path, III the fused path).
mp3fe_session* mp3fe_open_batch(const uint8_t* const* blobs,
                                const int64_t* lens, int32_t nfiles,
                                int32_t nthreads, mp3fe_info* infos_out,
                                int32_t* layers_out) {
  init_tables();
  auto* s = new mp3fe_session;
  s->blobs.assign(blobs, blobs + nfiles);
  s->lens.assign(lens, lens + nfiles);
  s->frames.resize(nfiles);
  s->infos.resize(nfiles);
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
      find_frames(s->blobs[b], s->lens[b], &s->frames[b]);
      probe_from_frames(s->frames[b], &s->infos[b]);
      if (infos_out) infos_out[b] = s->infos[b];
      if (layers_out) {
        static const int32_t kLayerMap[4] = {0, 3, 2, 1};  // header code
        layers_out[b] = s->frames[b].empty()
                            ? 0
                            : kLayerMap[s->frames[b][0].h.layer & 3];
      }
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int i = 0; i < nthreads; i++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return s;
}

void mp3fe_close(mp3fe_session* s) { delete s; }

// Lane emission for a subset of the session's files (threaded), reusing
// the open-time frame tables — no re-walk.  file_idx selects session
// files; outputs are strided [nsel, ...] exactly like mp3fe_lanes_batch.
void mp3fe_lanes_batch_session(
    mp3fe_session* s, const int32_t* file_idx, int32_t nsel, int32_t g_cap,
    int64_t m_cap, int32_t channels, uint8_t* main_out, int32_t* start_out,
    int32_t* end_out, int32_t* limit_out, int16_t* big_out, int16_t* r1_out,
    int16_t* r2_out, int8_t* tsel_out, int8_t* c1_out, int8_t* valid_out,
    int16_t* expb_out, int8_t* cfg_out, int8_t* stflags_out,
    int8_t* sfr_out, mp3fe_info* infos, int32_t nthreads) {
  init_tables();
  if (nthreads <= 0) {
    nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  if (nthreads > nsel) nthreads = nsel;
  std::atomic<int32_t> next(0);
  int64_t L = (int64_t)g_cap * channels;
  auto worker = [&]() {
    for (;;) {
      int32_t b = next.fetch_add(1);
      if (b >= nsel) return;
      int32_t f = file_idx[b];
      infos[b] = s->infos[f];
      // strided outputs assume the caller's channel count; reject a
      // mismatching blob instead of writing out of bounds
      if (infos[b].err == 0 && infos[b].channels != channels)
        infos[b].err = 3;
      if (infos[b].err != 0) continue;
      lanes_from_frames(s->blobs[f], s->lens[f], s->frames[f], g_cap, m_cap,
                        main_out + b * m_cap, start_out + b * L,
                        end_out + b * L, limit_out + b * L, big_out + b * L,
                        r1_out + b * L, r2_out + b * L, tsel_out + b * L * 3,
                        c1_out + b * L, valid_out + b * L,
                        expb_out + b * L * 61, cfg_out + b * L,
                        stflags_out + b * g_cap, sfr_out + b * g_cap * 61,
                        infos + b);
    }
  };
  if (nthreads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> ts;
  for (int i = 0; i < nthreads; i++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

}  // extern "C"
