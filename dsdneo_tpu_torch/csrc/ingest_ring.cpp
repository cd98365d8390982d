// SPDX-License-Identifier: MIT
//
// Host ingest ring of the live path (the port's copy of the JAX
// package's native/ingest_ring.cpp, unchanged in its logic):
//   - lock-free SPSC byte ring with producer-drop accounting and
//     generation counters for purge-on-retune (the reference keeps the
//     same contract in include/dsd-neo/runtime/input_ring.h:22-70);
//   - fused CU8 -> float32 I/Q widening with optional fs/4 rotation on
//     the consumer side (reference src/dsp/simd_widen*.cpp), emitting
//     [B, 2] float planes ready to move to the decode's device.
//
// Exposed as a plain C ABI consumed through ctypes
// (dsdneo_tpu_torch/runtime/native.py); no Python headers needed.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Ring {
    uint8_t* buf;
    size_t capacity;                 // power of two
    std::atomic<uint64_t> head;      // producer writes
    std::atomic<uint64_t> tail;      // consumer reads (sole writer)
    std::atomic<uint64_t> drops;     // bytes dropped when full
    std::atomic<uint32_t> generation;   // bumped by purge (retune)
    std::atomic<uint32_t> consumed_gen; // consumer's last-seen generation
    std::atomic<uint64_t> purge_upto;   // head position captured at purge
    std::atomic<int> shutdown;
};

inline size_t mask(const Ring* r, uint64_t v) {
    return static_cast<size_t>(v) & (r->capacity - 1);
}

}  // namespace

extern "C" {

Ring* dsd_ring_create(size_t capacity_pow2) {
    size_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    Ring* r = new Ring();
    r->buf = new uint8_t[cap];
    r->capacity = cap;
    r->head.store(0);
    r->tail.store(0);
    r->drops.store(0);
    r->generation.store(0);
    r->consumed_gen.store(0);
    r->purge_upto.store(0);
    r->shutdown.store(0);
    return r;
}

void dsd_ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->buf;
    delete r;
}

// Producer: write n bytes; drops the excess when the ring is full
// (producer never blocks — matches the reference's USB-callback contract).
// A truncated accept is rounded DOWN to whole CU8 samples (2 bytes):
// an odd drop count would flip the I/Q byte parity of the stream for
// the rest of the session with no framing to recover from.
size_t dsd_ring_write(Ring* r, const uint8_t* data, size_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t free_space = r->capacity - static_cast<size_t>(head - tail);
    size_t to_write = n < free_space ? n : (free_space & ~static_cast<size_t>(1));
    size_t off = mask(r, head);
    size_t first = to_write < (r->capacity - off) ? to_write
                                                  : (r->capacity - off);
    std::memcpy(r->buf + off, data, first);
    std::memcpy(r->buf, data + first, to_write - first);
    r->head.store(head + to_write, std::memory_order_release);
    if (to_write < n) {
        r->drops.fetch_add(n - to_write, std::memory_order_relaxed);
    }
    return to_write;
}

// Consumer: blocking read of exactly n bytes (or fewer on timeout /
// shutdown / purge).  Returns bytes read.
//
// Purge discipline: the control plane only bumps `generation`
// (dsd_ring_purge); the consumer itself advances tail to head when it
// observes the change.  Keeping tail single-writer avoids the lost-store
// race of a control-thread tail write colliding with the consumer's.
size_t dsd_ring_read(Ring* r, uint8_t* out, size_t n, int timeout_ms) {
    using clock = std::chrono::steady_clock;
    auto deadline = clock::now() + std::chrono::milliseconds(timeout_ms);
    size_t got = 0;
    while (got < n) {
        if (r->shutdown.load(std::memory_order_relaxed)) break;
        uint32_t gen = r->generation.load(std::memory_order_acquire);
        if (gen != r->consumed_gen.load(std::memory_order_relaxed)) {
            // retune purge: drop everything written BEFORE the purge was
            // requested (the watermark), keep post-retune samples, and
            // abandon the partial block
            uint64_t upto = r->purge_upto.load(std::memory_order_acquire);
            uint64_t tail = r->tail.load(std::memory_order_relaxed);
            if (upto > tail) {
                r->tail.store(upto, std::memory_order_release);
            }
            r->consumed_gen.store(gen, std::memory_order_relaxed);
            return 0;
        }
        uint64_t tail = r->tail.load(std::memory_order_relaxed);
        uint64_t head = r->head.load(std::memory_order_acquire);
        size_t avail = static_cast<size_t>(head - tail);
        if (avail == 0) {
            if (clock::now() > deadline) break;
            std::this_thread::sleep_for(std::chrono::microseconds(100));
            continue;
        }
        size_t take = avail < (n - got) ? avail : (n - got);
        size_t off = mask(r, tail);
        size_t first = take < (r->capacity - off) ? take
                                                  : (r->capacity - off);
        std::memcpy(out + got, r->buf + off, first);
        std::memcpy(out + got + first, r->buf, take - first);
        r->tail.store(tail + take, std::memory_order_release);
        got += take;
    }
    return got;
}

// Consumer: read 2*n_samples CU8 bytes and widen to float32 [n, 2]
// planes in [-1, 1], optionally applying the fs/4 rotation
// (rotate_dir = 0 none, +1 e^{+j pi n/2}, -1 e^{-j pi n/2}).
size_t dsd_ring_read_widen_cu8(Ring* r, float* out, size_t n_samples,
                               int rotate_dir, int timeout_ms) {
    // All-or-nothing block framing: wait until the FULL block is
    // available before consuming anything.  The previous incremental
    // read consumed a partial block and the caller then discarded it
    // on timeout — a silent gap in the I/Q stream even though the
    // samples eventually arrived and sat in the ring.
    const size_t n_bytes = 2 * n_samples;
    using clock = std::chrono::steady_clock;
    auto deadline = clock::now() + std::chrono::milliseconds(timeout_ms);
    for (;;) {
        if (r->shutdown.load(std::memory_order_relaxed)) return 0;
        uint32_t gen = r->generation.load(std::memory_order_acquire);
        if (gen != r->consumed_gen.load(std::memory_order_relaxed)) {
            uint64_t upto = r->purge_upto.load(std::memory_order_acquire);
            uint64_t tail = r->tail.load(std::memory_order_relaxed);
            if (upto > tail) {
                r->tail.store(upto, std::memory_order_release);
            }
            r->consumed_gen.store(gen, std::memory_order_relaxed);
            return 0;
        }
        uint64_t tail = r->tail.load(std::memory_order_relaxed);
        uint64_t head = r->head.load(std::memory_order_acquire);
        if (static_cast<size_t>(head - tail) >= n_bytes) break;
        if (clock::now() > deadline) return 0;  // nothing consumed
        std::this_thread::sleep_for(std::chrono::microseconds(100));
    }
    // per-thread scratch reused across blocks (consumer is SPSC);
    // two-segment memcpy keeps the widen loop linear + vectorizable
    thread_local std::vector<uint8_t> scratch;
    if (scratch.size() < n_bytes) scratch.resize(n_bytes);
    uint8_t* tmp = scratch.data();
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    size_t off = mask(r, tail);
    size_t first = n_bytes < (r->capacity - off) ? n_bytes
                                                 : (r->capacity - off);
    std::memcpy(tmp, r->buf + off, first);
    std::memcpy(tmp + first, r->buf, n_bytes - first);
    r->tail.store(tail + n_bytes, std::memory_order_release);
    size_t samples = n_samples;
    const float scale = 1.0f / 127.5f;
    for (size_t i = 0; i < samples; ++i) {
        float si = static_cast<float>(tmp[2 * i]) * scale - 1.0f;
        float sq = static_cast<float>(tmp[2 * i + 1]) * scale - 1.0f;
        if (rotate_dir != 0) {
            // multiply by j^{±n}: cycle (1, ±j, -1, ∓j)
            switch (i & 3) {
                case 0: break;
                case 1: { float t = si; si = rotate_dir > 0 ? -sq : sq;
                          sq = rotate_dir > 0 ? t : -t; break; }
                case 2: si = -si; sq = -sq; break;
                case 3: { float t = si; si = rotate_dir > 0 ? sq : -sq;
                          sq = rotate_dir > 0 ? -t : t; break; }
            }
        }
        out[2 * i] = si;
        out[2 * i + 1] = sq;
    }
    return samples;
}

// Control plane: request a purge.  Captures the current head as the
// drop watermark and flags the generation change; the consumer applies
// it on its next dsd_ring_read (consumer-driven purge keeps `tail`
// single-writer, and samples produced after the purge are preserved).
void dsd_ring_purge(Ring* r) {
    r->purge_upto.store(r->head.load(std::memory_order_acquire),
                        std::memory_order_release);
    r->generation.fetch_add(1, std::memory_order_acq_rel);
}

void dsd_ring_shutdown(Ring* r) { r->shutdown.store(1); }

// DSD_NEO_FTZ_DAZ: flush-to-zero / denormals-are-zero for the calling
// thread's FP unit (the reference sets MXCSR bits in dsd_main.cpp for
// the demod hot path; here the host-side resampler/ring math benefits
// the same way).  Returns 1 when applied, 0 when the platform has no
// such control (non-x86).
int dsd_set_ftz_daz(int enable) {
#if defined(__SSE2__)
    unsigned int csr = __builtin_ia32_stmxcsr();
    if (enable) {
        csr |= 0x8040;   // FTZ (bit 15) | DAZ (bit 6)
    } else {
        csr &= ~0x8040u;
    }
    __builtin_ia32_ldmxcsr(csr);
    return 1;
#else
    (void)enable;
    return 0;
#endif
}

uint64_t dsd_ring_drops(const Ring* r) { return r->drops.load(); }

size_t dsd_ring_fill(const Ring* r) {
    return static_cast<size_t>(r->head.load() - r->tail.load());
}

uint32_t dsd_ring_generation(const Ring* r) { return r->generation.load(); }

}  // extern "C"
