// K1: fused channel FIR + FM discriminator, [C, B] I/Q planes -> [C, B].
//
// Replaces the Pallas TPU kernel dsdneo_tpu/ops/pallas_frontend.py
// (_kernel, launched by _call, entry point fir_discriminate), which is
// bit-compatible with dsp.frontend fm_discriminate(fir_complex(x, taps)):
//
//   y[n]   = sum_t taps[t] * x[n + (T-1)/2 - t]        ("same", zero pad)
//   out[n] = atan2(Im(y[n] conj y[n-1]), Re(y[n] conj y[n-1])) / pi
//   out[:, 0] = 0
//
// What bounds it on an H100: with the P25 channel low-pass (143 taps) a
// sample costs 143 multiply-adds per plane, ~570 FLOP for 12 bytes moved
// (8 read, 4 written), so it is bound by FP32 throughput, not by memory.
// The design keeps every byte of the filtered complex signal on chip:
// a block of TILE threads owns TILE outputs of one channel, stages its
// tile plus a T-sample halo of I and Q (and the taps) in shared memory
// once, computes y at TILE+1 positions (the extra one is y[n-1] of the
// first lane) into shared memory, and writes only the discriminator.
// Reads of the staged input are conflict-free (consecutive lanes read
// consecutive words) and the taps are a shared-memory broadcast.
//
// The TPU kernel's band matrix (FIR as an MXU matmul) and its polynomial
// atan2 exist for the TPU; here the FIR is a direct loop and atan2 is
// atan2f.  Moving the FIR onto the tensor cores is later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;        // outputs per block (= threads per block)
constexpr int MAX_TAPS = 255;

__global__ void __launch_bounds__(TILE)
fir_disc_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ taps, int ntaps,
                float* __restrict__ out, int B) {
    __shared__ float s_taps[MAX_TAPS + 1];
    __shared__ float s_xr[TILE + MAX_TAPS + 1];
    __shared__ float s_xi[TILE + MAX_TAPS + 1];
    __shared__ float s_yr[TILE + 1];
    __shared__ float s_yi[TILE + 1];

    const int c = blockIdx.y;
    const int tile0 = blockIdx.x * TILE;
    const int half = (ntaps - 1) / 2;
    const float* rr = xr + (size_t)c * B;
    const float* ri = xi + (size_t)c * B;

    for (int t = threadIdx.x; t < ntaps; t += TILE) s_taps[t] = taps[t];
    // staged window: s[k] = x[base + k], k in [0, TILE + ntaps)
    const int base = tile0 - 1 + half - (ntaps - 1);
    const int nwin = TILE + ntaps;
    for (int k = threadIdx.x; k < nwin; k += TILE) {
        const int g = base + k;
        const bool in = (g >= 0) && (g < B);
        s_xr[k] = in ? rr[g] : 0.0f;
        s_xi[k] = in ? ri[g] : 0.0f;
    }
    __syncthreads();

    // y at m = tile0 - 1 + j, j in [0, TILE]: sum_t taps[t] s[j + T-1 - t]
    for (int j = threadIdx.x; j <= TILE; j += TILE) {
        float ar = 0.0f, ai = 0.0f;
        const int top = j + ntaps - 1;
        for (int t = 0; t < ntaps; ++t) {
            const float h = s_taps[t];
            ar = fmaf(h, s_xr[top - t], ar);
            ai = fmaf(h, s_xi[top - t], ai);
        }
        s_yr[j] = ar;
        s_yi[j] = ai;
    }
    __syncthreads();

    const int n = tile0 + threadIdx.x;
    if (n >= B) return;
    const float ycr = s_yr[threadIdx.x + 1], yci = s_yi[threadIdx.x + 1];
    const float ypr = s_yr[threadIdx.x], ypi = s_yi[threadIdx.x];
    const float re = ycr * ypr + yci * ypi;     // y[n] * conj(y[n-1])
    const float im = yci * ypr - ycr * ypi;
    out[(size_t)c * B + n] =
        (n == 0) ? 0.0f : atan2f(im, re) * 0.318309886183790671f;
}

}  // namespace

extern "C" int dsd_fir_disc(const float* xr, const float* xi,
                            const float* taps, int ntaps, float* out,
                            int C, int B, cudaStream_t stream) {
    if (ntaps < 1 || ntaps > MAX_TAPS || C < 1 || B < 1 || C > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((B + TILE - 1) / TILE, C);
    fir_disc_kernel<<<grid, TILE, 0, stream>>>(xr, xi, taps, ntaps, out, B);
    return (int)cudaGetLastError();
}
