// wavio.cpp — native IO runtime: WAV/RAW ingest + PCM->float conversion +
// lock-free SPSC ring buffer for the streaming (realtime-analogue) path.
//
// The port's own copy of project_desert_tortoise_tpu/native/wavio.cpp:
// the counterpart of the reference's C ingest layer
// (common/wave.c: ReadWavHeader wave.c:303, GetComplexWaveChunk wave.c:59,
// GetComplexRawChunk wave.c:413) and of the PortAudio callback plumbing in the
// realtime apps.  The hot loop (interleaved PCM -> planar float I/Q with
// normalization) is branch-free per format and auto-vectorizes; Python binds
// via ctypes (see wavio.py), which builds this file with g++ at first use.
//
// Build: project_desert_tortoise_tpu_torch/native/wavio.py::build

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

struct WavInfo {
  uint32_t sample_rate;
  uint16_t channels;
  uint16_t bits_per_sample;
  uint16_t format_type;
  uint32_t data_size;
  uint64_t n_frames;  // interleaved frames actually present after the header
};

// Parse the canonical 44-byte RIFF header (field-by-field little-endian,
// mirroring wave.c:329-375).  Returns 0 on success.
int pdt_parse_wav_header(const uint8_t* buf, uint64_t len, WavInfo* out) {
  if (len < 44) return -1;
  auto u16 = [&](int o) { return (uint16_t)(buf[o] | (buf[o + 1] << 8)); };
  auto u32 = [&](int o) {
    return (uint32_t)(buf[o] | (buf[o + 1] << 8) | (buf[o + 2] << 16) |
                      ((uint32_t)buf[o + 3] << 24));
  };
  out->format_type = u16(20);
  out->channels = u16(22);
  out->sample_rate = u32(24);
  out->bits_per_sample = u16(34);
  out->data_size = u32(40);
  uint64_t bytes_per_frame =
      (uint64_t)out->channels * out->bits_per_sample / 8;
  out->n_frames = bytes_per_frame ? (len - 44) / bytes_per_frame : 0;
  return 0;
}

// Interleaved 2-channel PCM -> planar float32 I/Q, normalized by
// 128 / 32768 / 2^31 (wave.c:109-124).  src points at the first frame.
int pdt_pcm_to_iq_f32(const uint8_t* src, uint64_t n_frames, int bits,
                      float* re, float* im) {
  if (bits == 16) {
    const int16_t* s = (const int16_t*)src;
    const float k = 1.0f / 32768.0f;
    for (uint64_t i = 0; i < n_frames; i++) {
      re[i] = (float)s[2 * i] * k;
      im[i] = (float)s[2 * i + 1] * k;
    }
  } else if (bits == 8) {
    // the reference keeps the raw unsigned byte value (wave.c:154)
    const float k = 1.0f / 128.0f;
    for (uint64_t i = 0; i < n_frames; i++) {
      re[i] = (float)src[2 * i] * k;
      im[i] = (float)src[2 * i + 1] * k;
    }
  } else if (bits == 32) {
    const int32_t* s = (const int32_t*)src;
    const float k = 1.0f / 2147483648.0f;
    for (uint64_t i = 0; i < n_frames; i++) {
      re[i] = (float)s[2 * i] * k;
      im[i] = (float)s[2 * i + 1] * k;
    }
  } else {
    return -1;
  }
  return 0;
}

// float64 variant (ARGOS runs the reference in double; config.h USE_FLOATS=0)
int pdt_pcm_to_iq_f64(const uint8_t* src, uint64_t n_frames, int bits,
                      double* re, double* im) {
  if (bits == 16) {
    const int16_t* s = (const int16_t*)src;
    const double k = 1.0 / 32768.0;
    for (uint64_t i = 0; i < n_frames; i++) {
      re[i] = s[2 * i] * k;
      im[i] = s[2 * i + 1] * k;
    }
  } else if (bits == 8) {
    const double k = 1.0 / 128.0;
    for (uint64_t i = 0; i < n_frames; i++) {
      re[i] = src[2 * i] * k;
      im[i] = src[2 * i + 1] * k;
    }
  } else if (bits == 32) {
    const int32_t* s = (const int32_t*)src;
    const double k = 1.0 / 2147483648.0;
    for (uint64_t i = 0; i < n_frames; i++) {
      re[i] = s[2 * i] * k;
      im[i] = s[2 * i + 1] * k;
    }
  } else {
    return -1;
  }
  return 0;
}

// SDR# RAW: interleaved float32 I/Q, no normalization (wave.c:442,489-499)
int pdt_raw_to_iq_f32(const uint8_t* src, uint64_t n_frames, float* re,
                      float* im) {
  const float* s = (const float*)src;
  for (uint64_t i = 0; i < n_frames; i++) {
    re[i] = s[2 * i];
    im[i] = s[2 * i + 1];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Lock-free single-producer/single-consumer ring buffer of float32 IQ frames,
// the streaming-session transport (PortAudio-callback analogue).  Capacity is
// rounded up to a power of two.

struct PdtRing {
  float* buf;          // interleaved re,im
  uint64_t capacity;   // frames, power of two
  uint64_t mask;
  std::atomic<uint64_t> head;  // write index (frames)
  std::atomic<uint64_t> tail;  // read index (frames)
  std::atomic<uint64_t> overruns;
};

PdtRing* pdt_ring_create(uint64_t capacity_frames) {
  uint64_t cap = 1;
  while (cap < capacity_frames) cap <<= 1;
  PdtRing* r = new PdtRing();
  r->buf = (float*)malloc(sizeof(float) * 2 * cap);
  if (!r->buf) { delete r; return nullptr; }
  r->capacity = cap;
  r->mask = cap - 1;
  r->head = 0;
  r->tail = 0;
  r->overruns = 0;
  return r;
}

void pdt_ring_destroy(PdtRing* r) {
  if (!r) return;
  free(r->buf);
  delete r;
}

uint64_t pdt_ring_capacity(PdtRing* r) { return r->capacity; }
uint64_t pdt_ring_available(PdtRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}
uint64_t pdt_ring_overruns(PdtRing* r) {
  return r->overruns.load(std::memory_order_relaxed);
}

// Producer: push n frames; drops (and counts) what does not fit — the
// realtime apps tolerate overflow with a message
// (POESTIPdemodPortAudio/main.c:327-331).
uint64_t pdt_ring_push(PdtRing* r, const float* re, const float* im,
                       uint64_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint64_t space = r->capacity - (head - tail);
  uint64_t todo = n < space ? n : space;
  for (uint64_t i = 0; i < todo; i++) {
    uint64_t slot = (head + i) & r->mask;
    r->buf[2 * slot] = re[i];
    r->buf[2 * slot + 1] = im[i];
  }
  r->head.store(head + todo, std::memory_order_release);
  if (todo < n)
    r->overruns.fetch_add(n - todo, std::memory_order_relaxed);
  return todo;
}

// Consumer: pop up to n frames into planar outputs; returns frames popped.
uint64_t pdt_ring_pop(PdtRing* r, float* re, float* im, uint64_t n) {
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t todo = n < avail ? n : avail;
  for (uint64_t i = 0; i < todo; i++) {
    uint64_t slot = (tail + i) & r->mask;
    re[i] = r->buf[2 * slot];
    im[i] = r->buf[2 * slot + 1];
  }
  r->tail.store(tail + todo, std::memory_order_release);
  return todo;
}

}  // extern "C"
