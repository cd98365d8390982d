// K8's second design (one warp of 32 rows a block; the tiles' copies and
// stores issued by the chain's own warp), which csrc/one_pole.cu
// replaced.  Not part of the kernels' library (kernels.py builds
// csrc/*.cu only): chip_smoke.py builds it with its own nvcc call
// beside the library's, holds it to the kernel bit for bit, times both
// and prints the instruction mix of its compiled tile loop.
//
// K8: the one-pole IIR over time of the decoded-audio filters, [R, T]
// float32 -> [R, T] float32:
//
//   y[-1] = 0;  y[n] = a * y[n-1] + (1 - a) * x[n]
//   out[n] = y[n]            (de-emphasis, the audio low-pass)
//   out[n] = x[n] - y[n]     (diff: the DC block, the audio high-pass)
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
// dsp/audio_filters.py rounds and flushes the same way).
//
// What bounds it: the chain of T dependent FMAs of each row (~4 cycles
// each: ~48 us at T = 24,000 and the SM's top clock), far above the
// bytes (2 x 4 x R x T over 3.35 TB/s, ~18 us at [320, 24000]).  A row
// lies T x 4 bytes from its neighbour, so one dependent global load per
// step would leave the chain waiting on device memory every step.
// Design: one thread per row, one warp per block over 32 rows; the rows
// pass through shared memory in tiles of [32 rows x 128 steps], loaded
// coalesced (a lane reads 16 bytes of each row of the tile with
// cp.async) kStages - 1 tiles ahead of the chain, so the chain runs out
// of shared memory; each thread writes its outputs over its inputs in
// the tile, and the warp stores the tile coalesced.  The tile's row
// stride of 132 floats keeps the threads' float4 reads of one column
// conflict-free.  Rows whose length is not a multiple of 4 (or that are
// not 16-byte aligned) take 4-byte copies.  With one warp on an SM, what
// remains is issue: the row loops of the copies and stores unroll and
// the 128 steps of a tile unroll with the output form (y or x - y) a
// template parameter, so the warp issues independent instructions back
// to back instead of waiting on each one's dependent address arithmetic
// (the first version, with a loop that ended on the last row, took
// ~3 us a tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;          // rows per block: one per lane
constexpr int kTile = 128;         // steps per tile
constexpr int kStride = kTile + 4;  // floats per tile row in shared memory
constexpr int kStages = 4;         // tiles in flight
constexpr int kSmemBytes = kStages * kRows * kStride * (int)sizeof(float);

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                     "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy tile k of the block's rows into stage buffer s; xl is the lane's
// first column of the block's first row.  The row loop unrolls, so its
// copies issue back to back.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* s, const float* xl,
                                          int nrows, int T, int k, int lane) {
    const int col = k * kTile + 4 * lane;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
        if (rr < nrows) {
            const float* src = xl + (int64_t)rr * T + k * kTile;
            float* dst = s + rr * kStride + 4 * lane;
            if (VEC) {
                if (col < T) cp_async<16>(dst, src);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (col + j < T) cp_async<4>(dst + j, src + j);
            }
        }
    }
}

template <bool VEC>
__device__ __forceinline__ void store_tile(const float* s, float* ol,
                                           int nrows, int T, int k,
                                           int lane) {
    const int col = k * kTile + 4 * lane;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
        if (rr < nrows) {
            float* dst = ol + (int64_t)rr * T + k * kTile;
            const float* src = s + rr * kStride + 4 * lane;
            if (VEC) {
                if (col < T)
                    *reinterpret_cast<float4*>(dst) =
                        *reinterpret_cast<const float4*>(src);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (col + j < T) dst[j] = src[j];
            }
        }
    }
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

template <bool DIFF>
__device__ __forceinline__ float step(float& y, float xv, float a, float b) {
    y = fma_ftz(a, y, mul_ftz(b, xv));
    return DIFF ? sub_ftz(xv, y) : y;
}

template <bool VEC, bool DIFF>
__global__ void __launch_bounds__(kRows)
    one_pole_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int R, int T, float a, float b) {
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * kRows;
    const int nrows = min(kRows, R - row0);
    const bool live = lane < nrows;
    const float* xl = x + (int64_t)row0 * T + 4 * lane;
    float* ol = out + (int64_t)row0 * T + 4 * lane;
    const int n_tiles = (T + kTile - 1) / kTile;

#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
        if (k < n_tiles)
            load_tile<VEC>(smem + k * kRows * kStride, xl, nrows, T, k, lane);
        cp_async_commit();
    }
    float y = 0.0f;
    for (int k = 0; k < n_tiles; ++k) {
        const int ahead = k + kStages - 1;
        if (ahead < n_tiles)
            load_tile<VEC>(smem + (ahead % kStages) * kRows * kStride, xl,
                           nrows, T, ahead, lane);
        cp_async_commit();
        cp_async_wait<kStages - 1>();           // tile k has landed
        __syncwarp();
        float* s = smem + (k % kStages) * kRows * kStride;
        float* mine = s + lane * kStride;
        const int n = min(kTile, T - k * kTile);
        if (live) {
            if (n == kTile) {
#pragma unroll
                for (int i = 0; i < kTile; i += 4) {
                    float4 v = *reinterpret_cast<float4*>(mine + i);
                    v.x = step<DIFF>(y, v.x, a, b);
                    v.y = step<DIFF>(y, v.y, a, b);
                    v.z = step<DIFF>(y, v.z, a, b);
                    v.w = step<DIFF>(y, v.w, a, b);
                    *reinterpret_cast<float4*>(mine + i) = v;
                }
            } else {
                for (int i = 0; i < n; ++i)
                    mine[i] = step<DIFF>(y, mine[i], a, b);
            }
        }
        __syncwarp();
        store_tile<VEC>(s, ol, nrows, T, k, lane);
        __syncwarp();                           // the stage may be reused
    }
}

template <bool VEC, bool DIFF>
cudaError_t launch(const float* x, float* out, int R, int T, float a,
                   float b, cudaStream_t stream) {
    const cudaError_t e = cudaFuncSetAttribute(
        one_pole_kernel<VEC, DIFF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    one_pole_kernel<VEC, DIFF><<<(R + kRows - 1) / kRows, kRows, kSmemBytes,
                                 stream>>>(x, out, R, T, a, b);
    return cudaGetLastError();
}

}  // namespace

extern "C" int dsd_one_pole(const float* x, float* out, int R, int T,
                            float a, float b, int diff,
                            cudaStream_t stream) {
    if (R < 0 || T < 0) return (int)cudaErrorInvalidValue;
    if (R == 0 || T == 0) return 0;
    const bool vec = T % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
    if (vec)
        return (int)(diff ? launch<true, true>(x, out, R, T, a, b, stream)
                          : launch<true, false>(x, out, R, T, a, b, stream));
    return (int)(diff ? launch<false, true>(x, out, R, T, a, b, stream)
                      : launch<false, false>(x, out, R, T, a, b, stream));
}
