// Verbatim copy of audio_decoder_tpu/native/runtime.cc (the port builds its own copy with g++).
// Native device/terminal runtime for the playback loop.
//
// The reference's native surface is Rust→C FFI: an ALSA mmap playback
// device (runtime.rs:251-394), a lock-free SPSC command ring crossing the
// REPL→audio thread boundary (commands.rs:11-69), and raw-terminal
// control with signal-safe restore (runtime.rs:396-458).  This file is
// the C++ equivalent; the compute half (the block renderer) stays JAX.
//
// ALSA is loaded with dlopen at runtime so the library builds and runs on
// audio-less TPU hosts (a null sink keeps the loop testable — the
// reference's hard `hw:0,0` coupling is what made its own tests
// unrunnable, SURVEY §4).
//
// Build: make -C audio_decoder_tpu/native  (produces libblastrt.so)

#include <dlfcn.h>
#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <termios.h>
#include <unistd.h>

#include <atomic>

// ---------------------------------------------------------------------------
// Lock-free SPSC ring of fixed-size command strings (≙ CmdQueue,
// commands.rs:11-69: capacity-1 usable slots, acquire/release ordering).
// ---------------------------------------------------------------------------

namespace {
constexpr int kSlot = 256;

struct Ring {
  int cap;
  std::atomic<uint32_t> head;  // consumer
  std::atomic<uint32_t> tail;  // producer
  char* slots;
};
}  // namespace

extern "C" {

void* spsc_create(int capacity) {
  Ring* r = new Ring();
  r->cap = capacity;
  r->head.store(0);
  r->tail.store(0);
  r->slots = new char[(size_t)capacity * kSlot]();
  return r;
}

void spsc_destroy(void* h) {
  Ring* r = (Ring*)h;
  delete[] r->slots;
  delete r;
}

// 0 on success, -1 when full (caller reports + drops, runtime.rs:156-162).
int spsc_push(void* h, const char* cmd) {
  Ring* r = (Ring*)h;
  uint32_t tail = r->tail.load(std::memory_order_relaxed);
  uint32_t next = (tail + 1) % r->cap;
  if (next == r->head.load(std::memory_order_acquire)) return -1;
  strncpy(r->slots + (size_t)tail * kSlot, cmd, kSlot - 1);
  r->slots[(size_t)tail * kSlot + kSlot - 1] = 0;
  r->tail.store(next, std::memory_order_release);
  return 0;
}

// 0 on success (out filled, out_cap >= 256), -1 when empty.
int spsc_pop(void* h, char* out) {
  Ring* r = (Ring*)h;
  uint32_t head = r->head.load(std::memory_order_relaxed);
  if (head == r->tail.load(std::memory_order_acquire)) return -1;
  memcpy(out, r->slots + (size_t)head * kSlot, kSlot);
  r->head.store((head + 1) % r->cap, std::memory_order_release);
  return 0;
}

// ---------------------------------------------------------------------------
// Raw terminal control (≙ raw_mode/read_char, runtime.rs:431-458)
// ---------------------------------------------------------------------------

static struct termios g_orig_term;
static std::atomic<int> g_term_saved(0);

int term_raw_on(void) {
  if (!isatty(STDIN_FILENO)) return -1;
  if (tcgetattr(STDIN_FILENO, &g_orig_term) != 0) return -1;
  g_term_saved.store(1);
  struct termios raw = g_orig_term;
  cfmakeraw(&raw);
  raw.c_oflag |= OPOST;  // keep \n → \r\n on output for sane prints
  return tcsetattr(STDIN_FILENO, TCSANOW, &raw);
}

int term_raw_off(void) {
  if (!g_term_saved.load()) return -1;
  return tcsetattr(STDIN_FILENO, TCSANOW, &g_orig_term);
}

// Blocking single-byte read; returns -1 on EOF/error.
int term_read_char(void) {
  unsigned char c;
  ssize_t n = read(STDIN_FILENO, &c, 1);
  return n == 1 ? (int)c : -1;
}

// ---------------------------------------------------------------------------
// Playback sink: ALSA when libasound is present, else null (timed drop).
//
// Two device paths (≙ runtime.rs:251-394):
//   * MMAP_INTERLEAVED with the reference's explicit geometry — hw params
//     period 128 frames / buffer 4x (runtime.rs:282-291), sw params
//     stop-threshold = boundary (never auto-stop), start-threshold =
//     avail_min = one period (runtime.rs:298-315), and the
//     avail_update / wait / mmap_begin / commit / start pacing loop
//     (runtime.rs:320-380);
//   * snd_pcm_writei fallback when mmap setup fails (robust, still
//     period-paced via set_params' latency hint).
// Xrun recovery via snd_pcm_recover mirrors runtime.rs:331-346 on both.
//
// The ALSA library name honors BLAST_ALSA_LIB so tests can inject a stub
// implementation and exercise the xrun/zero-write/mmap paths without
// audio hardware (the reference's hard hw:0,0 coupling is what made its
// own tests unrunnable, SURVEY §4).
// ---------------------------------------------------------------------------

static const unsigned kPeriod = 128;  // frames (runtime.rs:282-284)
static const unsigned kBufferPeriods = 4;  // buffer = 4 x period (:288-291)

typedef struct {
  void* addr;
  unsigned int first;  // bits
  unsigned int step;   // bits
} blast_pcm_area;

typedef struct {
  void* dl;
  void* pcm;
  int rate, channels;
  int is_null;
  int use_mmap;
  // resolved symbols (writei path)
  int (*open_)(void**, const char*, int, int);
  int (*set_params)(void*, int, int, unsigned, unsigned, int, unsigned);
  long (*writei)(void*, const void*, unsigned long);
  int (*recover)(void*, int, int);
  int (*close_)(void*);
  // mmap path
  unsigned long (*hw_sizeof)(void);
  int (*hw_any)(void*, void*);
  int (*hw_set_access)(void*, void*, int);
  int (*hw_set_format)(void*, void*, int);
  int (*hw_set_channels)(void*, void*, unsigned);
  int (*hw_set_rate)(void*, void*, unsigned, int);
  int (*hw_set_period)(void*, void*, unsigned long, int);
  int (*hw_set_buffer)(void*, void*, unsigned long);
  int (*hw_apply)(void*, void*);
  unsigned long (*sw_sizeof)(void);
  int (*sw_current)(void*, void*);
  int (*sw_get_boundary)(void*, unsigned long*);
  int (*sw_set_stop)(void*, void*, unsigned long);
  int (*sw_set_start)(void*, void*, unsigned long);
  int (*sw_set_avail)(void*, void*, unsigned long);
  int (*sw_apply)(void*, void*);
  int (*prepare)(void*);
  long (*avail_update)(void*);
  int (*wait_)(void*, int);
  int (*mmap_begin)(void*, const blast_pcm_area**, unsigned long*,
                    unsigned long*);
  long (*mmap_commit)(void*, unsigned long, unsigned long);
  int (*state_)(void*);
  int (*start_)(void*);
} Sink;

static int sink_try_mmap_setup(Sink* s) {
  // all mmap-path symbols must resolve
  s->hw_sizeof = (unsigned long (*)(void))dlsym(s->dl, "snd_pcm_hw_params_sizeof");
  s->hw_any = (int (*)(void*, void*))dlsym(s->dl, "snd_pcm_hw_params_any");
  s->hw_set_access = (int (*)(void*, void*, int))dlsym(s->dl, "snd_pcm_hw_params_set_access");
  s->hw_set_format = (int (*)(void*, void*, int))dlsym(s->dl, "snd_pcm_hw_params_set_format");
  s->hw_set_channels = (int (*)(void*, void*, unsigned))dlsym(s->dl, "snd_pcm_hw_params_set_channels");
  s->hw_set_rate = (int (*)(void*, void*, unsigned, int))dlsym(s->dl, "snd_pcm_hw_params_set_rate");
  s->hw_set_period = (int (*)(void*, void*, unsigned long, int))dlsym(s->dl, "snd_pcm_hw_params_set_period_size");
  s->hw_set_buffer = (int (*)(void*, void*, unsigned long))dlsym(s->dl, "snd_pcm_hw_params_set_buffer_size");
  s->hw_apply = (int (*)(void*, void*))dlsym(s->dl, "snd_pcm_hw_params");
  s->sw_sizeof = (unsigned long (*)(void))dlsym(s->dl, "snd_pcm_sw_params_sizeof");
  s->sw_current = (int (*)(void*, void*))dlsym(s->dl, "snd_pcm_sw_params_current");
  s->sw_get_boundary = (int (*)(void*, unsigned long*))dlsym(s->dl, "snd_pcm_sw_params_get_boundary");
  s->sw_set_stop = (int (*)(void*, void*, unsigned long))dlsym(s->dl, "snd_pcm_sw_params_set_stop_threshold");
  s->sw_set_start = (int (*)(void*, void*, unsigned long))dlsym(s->dl, "snd_pcm_sw_params_set_start_threshold");
  s->sw_set_avail = (int (*)(void*, void*, unsigned long))dlsym(s->dl, "snd_pcm_sw_params_set_avail_min");
  s->sw_apply = (int (*)(void*, void*))dlsym(s->dl, "snd_pcm_sw_params");
  s->prepare = (int (*)(void*))dlsym(s->dl, "snd_pcm_prepare");
  s->avail_update = (long (*)(void*))dlsym(s->dl, "snd_pcm_avail_update");
  s->wait_ = (int (*)(void*, int))dlsym(s->dl, "snd_pcm_wait");
  s->mmap_begin = (int (*)(void*, const blast_pcm_area**, unsigned long*,
                           unsigned long*))dlsym(s->dl, "snd_pcm_mmap_begin");
  s->mmap_commit = (long (*)(void*, unsigned long, unsigned long))dlsym(s->dl, "snd_pcm_mmap_commit");
  s->state_ = (int (*)(void*))dlsym(s->dl, "snd_pcm_state");
  s->start_ = (int (*)(void*))dlsym(s->dl, "snd_pcm_start");
  if (!s->hw_sizeof || !s->hw_any || !s->hw_set_access || !s->hw_set_format ||
      !s->hw_set_channels || !s->hw_set_rate || !s->hw_set_period ||
      !s->hw_set_buffer || !s->hw_apply || !s->sw_sizeof || !s->sw_current ||
      !s->sw_get_boundary || !s->sw_set_stop || !s->sw_set_start ||
      !s->sw_set_avail || !s->sw_apply || !s->prepare || !s->avail_update ||
      !s->wait_ || !s->mmap_begin || !s->mmap_commit || !s->state_ ||
      !s->start_)
    return -1;

  // hw params: MMAP_INTERLEAVED (0), S16_LE (2), explicit period/buffer
  // geometry (runtime.rs:267-295)
  char hw[4096];
  if (s->hw_sizeof() > sizeof(hw)) return -1;
  memset(hw, 0, sizeof(hw));
  if (s->hw_any(s->pcm, hw) < 0) return -1;
  if (s->hw_set_access(s->pcm, hw, 0) < 0) return -1;
  if (s->hw_set_format(s->pcm, hw, 2) < 0) return -1;
  if (s->hw_set_channels(s->pcm, hw, (unsigned)s->channels) < 0) return -1;
  if (s->hw_set_rate(s->pcm, hw, (unsigned)s->rate, 0) < 0) return -1;
  if (s->hw_set_period(s->pcm, hw, kPeriod, 0) < 0) return -1;
  if (s->hw_set_buffer(s->pcm, hw, kPeriod * kBufferPeriods) < 0) return -1;
  if (s->hw_apply(s->pcm, hw) < 0) return -1;

  // sw params: stop-threshold = boundary (never auto-stop on underrun),
  // start at one period, wake when a period is writable
  // (runtime.rs:298-315)
  char sw[4096];
  if (s->sw_sizeof() > sizeof(sw)) return -1;
  memset(sw, 0, sizeof(sw));
  if (s->sw_current(s->pcm, sw) < 0) return -1;
  unsigned long boundary = 0;
  if (s->sw_get_boundary(sw, &boundary) < 0) return -1;
  if (s->sw_set_stop(s->pcm, sw, boundary) < 0) return -1;
  if (s->sw_set_start(s->pcm, sw, kPeriod) < 0) return -1;
  if (s->sw_set_avail(s->pcm, sw, kPeriod) < 0) return -1;
  if (s->sw_apply(s->pcm, sw) < 0) return -1;
  if (s->prepare(s->pcm) < 0) return -1;
  return 0;
}

// mode: 0 = auto (mmap, writei fallback), 1 = writei only, 2 = mmap only
extern "C" void* sink_open_mode(const char* device, int rate, int channels,
                                int mode) {
  Sink* s = new Sink();
  memset(s, 0, sizeof(*s));
  s->rate = rate;
  s->channels = channels;
  const char* libname = getenv("BLAST_ALSA_LIB");
  if (!libname || !libname[0]) libname = "libasound.so.2";
  s->dl = dlopen(libname, RTLD_NOW);
  if (!s->dl) {
    s->is_null = 1;
    return s;
  }
  s->open_ = (int (*)(void**, const char*, int, int))dlsym(s->dl, "snd_pcm_open");
  s->set_params = (int (*)(void*, int, int, unsigned, unsigned, int, unsigned))
      dlsym(s->dl, "snd_pcm_set_params");
  s->writei = (long (*)(void*, const void*, unsigned long))
      dlsym(s->dl, "snd_pcm_writei");
  s->recover = (int (*)(void*, int, int))dlsym(s->dl, "snd_pcm_recover");
  s->close_ = (int (*)(void*))dlsym(s->dl, "snd_pcm_close");
  if (!s->open_ || !s->recover || !s->close_) {
    s->is_null = 1;
    return s;
  }
  // SND_PCM_STREAM_PLAYBACK = 0, blocking mode
  if (s->open_(&s->pcm, device, 0, 0) < 0) {
    s->is_null = 1;
    return s;
  }
  if (mode != 1 && sink_try_mmap_setup(s) == 0) {
    s->use_mmap = 1;
    return s;
  }
  if (mode == 2) {  // mmap required but unsupported
    s->close_(s->pcm);
    s->is_null = 1;
    return s;
  }
  // writei fallback: format S16_LE = 2, access RW_INTERLEAVED = 3,
  // latency hint = the same 4 x 128-frame geometry
  unsigned latency_us = (unsigned)(kPeriod * kBufferPeriods * 1e6 / rate);
  if (!s->set_params || !s->writei ||
      s->set_params(s->pcm, 2, 3, (unsigned)channels, (unsigned)rate, 1,
                    latency_us) < 0) {
    s->close_(s->pcm);
    s->is_null = 1;
  }
  return s;
}

extern "C" void* sink_open(const char* device, int rate, int channels) {
  return sink_open_mode(device, rate, channels, 0);
}

extern "C" int sink_is_null(void* h) { return ((Sink*)h)->is_null; }

// 0 = null, 1 = writei, 2 = mmap
extern "C" int sink_mode(void* h) {
  Sink* s = (Sink*)h;
  return s->is_null ? 0 : (s->use_mmap ? 2 : 1);
}

// mmap-path write: avail_update -> wait -> mmap_begin/copy/commit ->
// start (runtime.rs:320-380), recover on xruns at every device call site.
static int sink_write_mmap(Sink* s, const int16_t* frames, int n_frames) {
  long done = 0;
  int stalls = 0;
  while (done < n_frames) {
    long avail = s->avail_update(s->pcm);
    if (avail < 0) {
      if (s->recover(s->pcm, (int)avail, 1) < 0) return (int)avail;
      s->prepare(s->pcm);
      continue;
    }
    if ((unsigned long)avail < kPeriod) {
      // buffer full: make sure the stream is consuming, then sleep
      // until a period frees up (snd_pcm_wait, runtime.rs:340-346)
      if (s->state_(s->pcm) != 3 /* RUNNING */) s->start_(s->pcm);
      int w = s->wait_(s->pcm, 100);
      if (w < 0 && s->recover(s->pcm, w, 1) < 0) return w;
      if (++stalls > 1000) return -EIO;  // wedged device
      continue;
    }
    stalls = 0;
    const blast_pcm_area* areas = NULL;
    unsigned long offset = 0;
    unsigned long want = (unsigned long)(n_frames - done);
    if (want > (unsigned long)avail) want = (unsigned long)avail;
    unsigned long got = want;
    int rc = s->mmap_begin(s->pcm, &areas, &offset, &got);
    if (rc < 0) {
      if (s->recover(s->pcm, rc, 1) < 0) return rc;
      continue;
    }
    // interleaved S16: area[c] shares addr, first = c*16, step = ch*16 —
    // one contiguous memcpy; fall back to per-channel strided copy for
    // exotic layouts
    const int ch = s->channels;
    if (areas[0].step == (unsigned)(ch * 16) && (areas[0].first % 8) == 0) {
      int16_t* dst = (int16_t*)((char*)areas[0].addr + areas[0].first / 8 +
                                offset * (areas[0].step / 8));
      memcpy(dst, frames + done * ch, got * ch * sizeof(int16_t));
    } else {
      for (int c = 0; c < ch; c++) {
        char* base = (char*)areas[c].addr + areas[c].first / 8;
        for (unsigned long f = 0; f < got; f++) {
          int16_t* dst = (int16_t*)(base + (offset + f) * (areas[c].step / 8));
          *dst = frames[(done + f) * ch + c];
        }
      }
    }
    long committed = s->mmap_commit(s->pcm, offset, got);
    if (committed < 0) {
      if (s->recover(s->pcm, (int)committed, 1) < 0) return (int)committed;
      continue;
    }
    done += committed;
    if (s->state_(s->pcm) != 3 /* RUNNING */) s->start_(s->pcm);
  }
  return (int)done;
}

// Write interleaved S16 frames; paces a null sink by sleeping the block's
// real-time duration so the loop behaves like a device.
extern "C" int sink_write(void* h, const int16_t* frames, int n_frames) {
  Sink* s = (Sink*)h;
  if (s->is_null) {
    usleep((useconds_t)((double)n_frames * 1e6 / s->rate));
    return n_frames;
  }
  if (s->use_mmap) return sink_write_mmap(s, frames, n_frames);
  long written = 0;
  int zero_writes = 0;
  const int16_t* p = frames;
  while (written < n_frames) {
    long rc = s->writei(s->pcm, p, (unsigned long)(n_frames - written));
    if (rc < 0) {
      rc = s->recover(s->pcm, (int)rc, 1);  // xrun recovery
      if (rc < 0) return (int)rc;
      continue;
    }
    if (rc == 0) {
      // ALSA can report 0 frames accepted (e.g. draining/odd states);
      // back off briefly and bail after ~1 s instead of spinning the
      // render thread forever
      if (++zero_writes > 1000) return -EIO;
      usleep(1000);
      continue;
    }
    zero_writes = 0;
    written += rc;
    p += rc * s->channels;
  }
  return (int)written;
}

extern "C" void sink_close(void* h) {
  Sink* s = (Sink*)h;
  if (!s->is_null && s->pcm) s->close_(s->pcm);
  if (s->dl) dlclose(s->dl);
  delete s;
}

}  // extern "C"
