// apvast_rt — native real-time audio host runtime for the AP-VAST engine
// (the port's own copy of native/apvast_rt.cpp, built by
// apvast_torch/runtime/native.py).
//
// The reference implementation is an offline script (Matlab/main.m reads
// whole files); a deployed sound-zone system sits between a sound-card
// callback and the filter engine, where Python cannot give real-time
// guarantees. This small C library provides the native glue:
//
//   * lock-free single-producer/single-consumer float ring buffers
//     (audio-callback safe: no locks, no allocation on the hot path),
//   * a hop framer that turns arbitrary-sized callback chunks into the
//     fixed hop blocks the engine consumes,
//   * xrun (overrun/underrun) accounting.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency). Built at
// first use with g++ into apvast_torch/_build/, under a hash of this file.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------
// SPSC ring buffer
// ---------------------------------------------------------------------

struct ApvastRing {
  float* data;
  uint64_t capacity;  // power of two
  std::atomic<uint64_t> head;  // write position (producer)
  std::atomic<uint64_t> tail;  // read position (consumer)
  std::atomic<uint64_t> overruns;
  std::atomic<uint64_t> underruns;
};

static uint64_t next_pow2(uint64_t n) {
  uint64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

ApvastRing* apvast_ring_create(uint64_t min_capacity) {
  auto* r = new (std::nothrow) ApvastRing();
  if (!r) return nullptr;
  r->capacity = next_pow2(min_capacity < 2 ? 2 : min_capacity);
  r->data = new (std::nothrow) float[r->capacity];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->overruns.store(0, std::memory_order_relaxed);
  r->underruns.store(0, std::memory_order_relaxed);
  return r;
}

void apvast_ring_destroy(ApvastRing* r) {
  if (!r) return;
  delete[] r->data;
  delete r;
}

uint64_t apvast_ring_capacity(const ApvastRing* r) { return r->capacity; }

uint64_t apvast_ring_readable(const ApvastRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

uint64_t apvast_ring_writable(const ApvastRing* r) {
  return r->capacity - apvast_ring_readable(r);
}

// Write up to n samples; returns samples written. Short writes count one
// overrun (producer outpaced the consumer).
uint64_t apvast_ring_write(ApvastRing* r, const float* src, uint64_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint64_t space = r->capacity - (head - tail);
  uint64_t todo = n < space ? n : space;
  if (todo < n) r->overruns.fetch_add(1, std::memory_order_relaxed);
  const uint64_t mask = r->capacity - 1;
  uint64_t pos = head & mask;
  uint64_t first = todo < (r->capacity - pos) ? todo : (r->capacity - pos);
  std::memcpy(r->data + pos, src, first * sizeof(float));
  std::memcpy(r->data, src + first, (todo - first) * sizeof(float));
  r->head.store(head + todo, std::memory_order_release);
  return todo;
}

// Read up to n samples; returns samples read. Short reads count one
// underrun.
uint64_t apvast_ring_read(ApvastRing* r, float* dst, uint64_t n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t todo = n < avail ? n : avail;
  if (todo < n) r->underruns.fetch_add(1, std::memory_order_relaxed);
  const uint64_t mask = r->capacity - 1;
  uint64_t pos = tail & mask;
  uint64_t first = todo < (r->capacity - pos) ? todo : (r->capacity - pos);
  std::memcpy(dst, r->data + pos, first * sizeof(float));
  std::memcpy(dst + first, r->data, (todo - first) * sizeof(float));
  r->tail.store(tail + todo, std::memory_order_release);
  return todo;
}

uint64_t apvast_ring_overruns(const ApvastRing* r) {
  return r->overruns.load(std::memory_order_relaxed);
}
uint64_t apvast_ring_underruns(const ApvastRing* r) {
  return r->underruns.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------
// Hop framer: turn arbitrary chunk sizes into fixed hop frames.
// ---------------------------------------------------------------------

struct ApvastFramer {
  ApvastRing* ring;
  uint64_t hop;
};

ApvastFramer* apvast_framer_create(uint64_t hop, uint64_t max_backlog_hops) {
  auto* f = new (std::nothrow) ApvastFramer();
  if (!f) return nullptr;
  f->hop = hop;
  f->ring = apvast_ring_create(hop * (max_backlog_hops + 1));
  if (!f->ring) {
    delete f;
    return nullptr;
  }
  return f;
}

void apvast_framer_destroy(ApvastFramer* f) {
  if (!f) return;
  apvast_ring_destroy(f->ring);
  delete f;
}

uint64_t apvast_framer_push(ApvastFramer* f, const float* src, uint64_t n) {
  return apvast_ring_write(f->ring, src, n);
}

// Number of complete hops ready to pop.
uint64_t apvast_framer_ready(const ApvastFramer* f) {
  return apvast_ring_readable(f->ring) / f->hop;
}

// Pop exactly one hop into dst; returns 1 on success, 0 if not ready.
int apvast_framer_pop(ApvastFramer* f, float* dst) {
  if (apvast_framer_ready(f) == 0) return 0;
  apvast_ring_read(f->ring, dst, f->hop);
  return 1;
}

uint64_t apvast_framer_dropped(const ApvastFramer* f) {
  return apvast_ring_overruns(f->ring);
}

// Free sample capacity (for atomic multi-framer admission control).
uint64_t apvast_framer_writable(const ApvastFramer* f) {
  return apvast_ring_writable(f->ring);
}

}  // extern "C"
