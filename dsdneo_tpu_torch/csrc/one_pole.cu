// K8: the one-pole IIR over time of the decoded-audio filters, [R, T]
// float32 -> [R, T] float32:
//
//   y[-1] = 0;  y[n] = a * y[n-1] + (1 - a) * x[n]
//   out[n] = y[n]            (de-emphasis, the audio low-pass)
//   out[n] = x[n] - y[n]     (diff: the DC block, the audio high-pass)
//   out[n] = z[n]            (cascade: z[n] = a2 * z[n-1] + (1 - a2) * y[n],
//                             the de-emphasis then the low-pass)
//
// With a state ([R, 2] float32: y, z of each row), y[-1] and z[-1] are
// read from it and y[T-1], z[T-1] written back, so successive blocks of
// the same rows come out as one call on their concatenation would.
//
// Replaces dsdneo_tpu/dsp/audio_filters.py _one_pole (a lax.scan over the
// last axis).  XLA's CPU backend evaluates the scan body as
// fma(f32(a), y, f32(f32(1 - a) * x[n])): one rounded product and one
// fused multiply-add, with subnormal inputs and results flushed to zero
// (a silent stretch decays the state into that range within ~500
// steps).  Each step here is the same: mul.rn.ftz then fma.rn.ftz with
// a = f32(a), b = f32(1 - a) computed by the caller in double, and
// sub.rn.ftz for the diff output, so the result equals the JAX
// function's bit for bit (the plain PyTorch version in
// dsp/audio_filters.py rounds and flushes the same way).  The cascade's
// second filter takes the first one's y[n] of the same step from a
// register: the same operations in the same order as two launches, so
// it equals two plain calls bit for bit, in one pass over the bytes.
// The recurrence is never reassociated (a chunked scan would round
// differently).
//
// What bounds it: the chain of T dependent FMAs of each row (~4 cycles
// each: ~48 us at T = 24,000 and the SM's top clock), far above the
// bytes (2 x 4 x R x T over 3.35 TB/s, ~18 us at [320, 24000]).  A row
// lies T x 4 bytes from its neighbour, so one dependent global load per
// step would leave the chain waiting on device memory every step.
//
// What the second version (one warp of 32 rows a block) lost: that warp
// also issued the tiles' copies (a cp.async per row and tile), their
// global stores and three __syncwarp a tile, in order with the chain,
// so the chain waited on the copies and the copies on the chain: ~29
// cycles a step against the FMA's 4.  Rows whose length is not a
// multiple of 4 took four 4-byte copies and stores a row and lane.
//
// Design: a block is a producer warp and kRows chain threads (one per
// row), the rows pass through shared memory in tiles of [kRows x kTile
// steps], kStages tiles in flight.  The producer's lane r moves row r:
// one Hopper bulk copy (cp.async.bulk, completing on the stage's "full"
// mbarrier) of the 16-byte-aligned superset of the row's tile segment,
// so a ragged row (T % 4 != 0) or an unaligned view is copied whole,
// 16 bytes at a time, and read at its offset (the superset lies within
// the 16-byte units that hold the row's own bytes, so it reads no page
// the tensor does not touch); after the chain thread has arrived on the
// stage's "done" mbarrier, one bulk store of the 16-byte-aligned
// interior of the output segment and at most three 4-byte stores at
// each end; then, once that store has read its source, the next tile's
// copy into the stage.  No tensor map: a copy per row segment serves
// every row length and alignment in one code path, with nothing to
// encode on the host.  The chain thread only waits on the mbarrier,
// reads shared memory (16 steps ahead of the chain, float4 when the rows
// are 16-byte aligned), runs the mul / fma (/ sub) of each step and
// writes shared memory; the b*x products depend on no state, so they
// issue off the chain.  The staged row's pitch of kTile + 4 floats (4
// mod 32) keeps a quarter-warp's float4 reads, and up to 8 rows' 4-byte
// reads, conflict-free.  8 rows a block: fewer rows a block spread the
// rows over more SMs and cut each SM's copies a tile (chip_smoke.py
// builds this file again at 16 and 32 rows, DSD_K8_ROWS, and times the
// three side by side).  On 16-byte-aligned rows the one-filter step is
// a mul, an fma and a quarter of a float4 load and store; the cascade's
// two mul/fma pairs and the shared loads and stores nearly fill the
// warp's issue; ragged rows and unaligned views load and store shared
// memory 4 bytes a step each, which doubles those instructions
// (chip_smoke.py prints each form's cycles a step, from the slope of
// its time over T).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef DSD_K8_ROWS
#define DSD_K8_ROWS 8
#endif
constexpr int kStages = 4;          // tiles in flight per block
constexpr int kRows = DSD_K8_ROWS;  // rows a block, one chain thread each
// steps a tile; run_tile unrolls a tile whole (the cascade unrolled at
// 512 steps ran slower, most likely past the instruction cache).  32
// rows of 256-step tiles would outgrow shared memory: 128 steps there
constexpr int kTile = kRows > 16 ? 128 : 256;
static_assert(kTile % 16 == 0, "run_tile takes 16 steps at a time");
// a 16-byte-aligned superset of kTile floats spans at most kTile + 4
constexpr int kPitch = kTile + 4;
constexpr int kStageFloats = kRows * kPitch;
constexpr int kBarBytes = 128;      // the mbarriers, ahead of the tiles
constexpr int kSmemBytes =
    kBarBytes + 2 * kStages * kStageFloats * (int)sizeof(float);

enum Mode { kY = 0, kDiff = 1, kCascade = 2 };

__device__ __forceinline__ unsigned sptr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sptr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sptr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sptr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(sptr(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sptr(dst)),
      "l"(src), "r"(bytes), "r"(sptr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(sptr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, made visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// round-to-nearest float32 arithmetic that flushes subnormal inputs and
// results to signed zero, whatever the compiler's -ftz setting
__device__ __forceinline__ float mul_ftz(float p, float q) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(p), "f"(q));
  return r;
}

__device__ __forceinline__ float fma_ftz(float p, float q, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(p), "f"(q), "f"(c));
  return r;
}

__device__ __forceinline__ float sub_ftz(float p, float q) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(p), "f"(q));
  return r;
}

struct Coef {
  float a, b, a2, b2;
};

// one step of the row's filter(s) on input xv; returns the output
template <int kMode>
__device__ __forceinline__ float step(float& y, float& z, float xv,
                                      const Coef& c) {
  y = fma_ftz(c.a, y, mul_ftz(c.b, xv));
  if (kMode == kCascade) {
    z = fma_ftz(c.a2, z, mul_ftz(c.b2, y));
    return z;
  }
  return kMode == kDiff ? sub_ftz(xv, y) : y;
}

// a full tile's kTile steps from in[] to o[], the inputs of the next 16
// steps loaded before the 16 steps in hand run (float4 reads when kVec)
template <int kMode, bool kVec>
__device__ __forceinline__ void run_tile(const float* in, float* o,
                                         float& y, float& z, const Coef& c) {
  float cur[16], nxt[16];
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    if (kVec) {
      const float4 v = *reinterpret_cast<const float4*>(in + j);
      cur[j] = v.x, cur[j + 1] = v.y, cur[j + 2] = v.z, cur[j + 3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[j + q] = in[j + q];
    }
  }
#pragma unroll
  for (int i = 0; i < kTile; i += 16) {
    if (i + 16 < kTile) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        if (kVec) {
          const float4 v = *reinterpret_cast<const float4*>(in + i + 16 + j);
          nxt[j] = v.x, nxt[j + 1] = v.y, nxt[j + 2] = v.z, nxt[j + 3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) nxt[j + q] = in[i + 16 + j + q];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) cur[j] = step<kMode>(y, z, cur[j], c);
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      if (kVec) {
        *reinterpret_cast<float4*>(o + i + j) =
            make_float4(cur[j], cur[j + 1], cur[j + 2], cur[j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) o[i + j + q] = cur[j + q];
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) cur[j] = nxt[j];
  }
}

// kVec: T % 4 == 0 and both tensors 16-byte aligned, so every row
// segment is 16-byte aligned and the superset is the segment itself
template <int kMode, bool kVec>
__global__ void __launch_bounds__(32 + kRows)
    one_pole_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ state, int R, int T, Coef c) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* done = full + kStages;
  float* s_in = reinterpret_cast<float*>(smem + kBarBytes);
  float* s_out = s_in + kStages * kStageFloats;

  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, R - row0);
  const int n_tiles = (T + kTile - 1) / kTile;
  const bool producer = threadIdx.x < 32;
  const int r = producer ? threadIdx.x : threadIdx.x - 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], nrows);
      mbar_init(&done[s], nrows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (r >= nrows) return;

  const int64_t row_off = (int64_t)(row0 + r) * T;
  const float* xr = x + row_off;
  float* orow = out + row_off;

  if (producer) {
    auto load = [&](int k) {
      const int s = k % kStages;
      const uintptr_t lo = (uintptr_t)(xr + k * kTile);
      const uintptr_t hi = (uintptr_t)(xr + min(T, (k + 1) * kTile));
      const uintptr_t a_lo = lo & ~(uintptr_t)15;
      const unsigned bytes =
          (unsigned)(((hi + 15) & ~(uintptr_t)15) - a_lo);
      mbar_arrive_tx(&full[s], bytes);
      bulk_load(s_in + s * kStageFloats + r * kPitch,
                reinterpret_cast<const void*>(a_lo), bytes, &full[s]);
    };
    for (int k = 0; k < kStages && k < n_tiles; ++k) load(k);
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kStages;
      mbar_wait(&done[s], (k / kStages) & 1);
      // the staged output row holds the bytes from the 16-byte unit of
      // the segment's first byte on
      const char* src = reinterpret_cast<const char*>(
          s_out + s * kStageFloats + r * kPitch);
      const uintptr_t lo = (uintptr_t)(orow + k * kTile);
      const uintptr_t hi = (uintptr_t)(orow + min(T, (k + 1) * kTile));
      const uintptr_t base = lo & ~(uintptr_t)15;
      const uintptr_t i_lo = (lo + 15) & ~(uintptr_t)15;
      const uintptr_t i_hi = hi & ~(uintptr_t)15;
      if (i_lo < i_hi)
        bulk_store(reinterpret_cast<void*>(i_lo), src + (i_lo - base),
                   (unsigned)(i_hi - i_lo));
      if (!kVec) {          // the unaligned ends, 4 bytes at a time
        const uintptr_t head_end = i_lo < hi ? i_lo : hi;
        for (uintptr_t p = lo; p < head_end; p += 4)
          *reinterpret_cast<float*>(p) =
              *reinterpret_cast<const float*>(src + (p - base));
        const uintptr_t tail = i_hi > head_end ? i_hi : head_end;
        for (uintptr_t p = tail; p < hi; p += 4)
          *reinterpret_cast<float*>(p) =
              *reinterpret_cast<const float*>(src + (p - base));
      }
      bulk_commit();
      if (k + kStages < n_tiles) {
        bulk_wait_read();           // the stage's output row is read
        load(k + kStages);
      }
    }
    bulk_wait();
    return;
  }

  // the chain thread of row r
  const int m_in = kVec ? 0 : (int)(((uintptr_t)xr & 15) >> 2);
  const int m_out = kVec ? 0 : (int)(((uintptr_t)orow & 15) >> 2);
  float y = 0.0f, z = 0.0f;
  if (state != nullptr) {
    y = state[2 * (row0 + r)];
    z = state[2 * (row0 + r) + 1];
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    const float* in = s_in + s * kStageFloats + r * kPitch + m_in;
    float* o = s_out + s * kStageFloats + r * kPitch + m_out;
    const int n = min(kTile, T - k * kTile);
    if (n == kTile) {
      run_tile<kMode, kVec>(in, o, y, z, c);
    } else {
      for (int i = 0; i < n; ++i) o[i] = step<kMode>(y, z, in[i], c);
    }
    fence_async_shared();
    mbar_arrive(&done[s]);
  }
  if (state != nullptr) {
    state[2 * (row0 + r)] = y;
    state[2 * (row0 + r) + 1] = z;
  }
}

template <int kMode, bool kVec>
cudaError_t launch(const float* x, float* out, float* state, int R, int T,
                   Coef c, cudaStream_t stream) {
  // more than 48 KB of shared memory: opted in on the current device
  const cudaError_t e = cudaFuncSetAttribute(
      one_pole_kernel<kMode, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  one_pole_kernel<kMode, kVec>
      <<<(R + kRows - 1) / kRows, 32 + kRows, kSmemBytes, stream>>>(
          x, out, state, R, T, c);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(bool vec, const float* x, float* out, float* state,
                        int R, int T, Coef c, cudaStream_t stream) {
  return vec ? launch<kMode, true>(x, out, state, R, T, c, stream)
             : launch<kMode, false>(x, out, state, R, T, c, stream);
}

}  // namespace

// x, out: [R, T] float32, contiguous, 4-byte aligned.  mode 0: y; 1:
// x - y; 2: the cascade (a, b) then (a2, b2).  state: null (both
// filters start from 0), or [R, 2] float32, read and written in place
extern "C" int dsd_one_pole(const float* x, float* out, int R, int T,
                            float a, float b, float a2, float b2, int mode,
                            float* state, cudaStream_t stream) {
  if (R < 0 || T < 0 || mode < kY || mode > kCascade)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return 0;
  const bool vec = T % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const Coef c{a, b, a2, b2};
  switch (mode) {
    case kY:
      return (int)launch_mode<kY>(vec, x, out, state, R, T, c, stream);
    case kDiff:
      return (int)launch_mode<kDiff>(vec, x, out, state, R, T, c, stream);
    default:
      return (int)launch_mode<kCascade>(vec, x, out, state, R, T, c,
                                        stream);
  }
}
