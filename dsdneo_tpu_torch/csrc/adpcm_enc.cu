// K3: IMA/DVI-4 ADPCM encoder, [S, T] float PCM -> [S, T/2] packed codes.
//
// Replaces dsdneo_tpu/ops/audio_wire.py adpcm_compress, a lax.scan over
// the sample axis.  Each stream starts from (predictor 0, index 0);
// samples quantize as round-half-to-even(pcm * 32767) (__float2int_rn,
// the rounding of jnp.round); two 4-bit codes pack per byte, the even
// sample in the low nibble.  The output is bit-identical to the JAX
// encoder.
//
// What bounds it on an H100: the recurrence.  Every sample's code
// depends on the previous sample's predictor and step index, so a
// stream is strictly sequential and the only parallel axis is the
// stream count: at C=320 channels that is 320 threads on a card built
// for ~270,000 resident threads.  The design is the plainest that is
// right: one thread per stream walking its samples, both tables in
// __constant__ memory.  Loads are per-thread sequential (uncoalesced
// across a warp; the L1 line of each stream serves its next 31 samples).
// The time is recorded in PERF.md and left as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_step[89];
__constant__ int c_index[16];

__global__ void adpcm_enc_kernel(const float* __restrict__ pcm,
                                 uint8_t* __restrict__ out, int S, int T) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const float* x = pcm + (size_t)s * T;
    uint8_t* o = out + (size_t)s * (T / 2);
    int pred = 0, idx = 0;
    uint8_t lo = 0;
    for (int t = 0; t < T; ++t) {
        const int xt = __float2int_rn(x[t] * 32767.0f);
        const int step = c_step[idx];
        const int diff = xt - pred;
        const int sign = diff < 0;
        int ad = diff < 0 ? -diff : diff;
        const int b2 = ad >= step;
        ad -= b2 * step;
        const int h1 = step >> 1;
        const int b1 = ad >= h1;
        ad -= b1 * h1;
        const int h2 = step >> 2;
        const int b0 = ad >= h2;
        const int vpdiff = (step >> 3) + b2 * step + b1 * h1 + b0 * h2;
        pred += sign ? -vpdiff : vpdiff;
        pred = min(max(pred, -32768), 32767);
        const int code = (sign << 3) | (b2 << 2) | (b1 << 1) | b0;
        idx = min(max(idx + c_index[code], 0), 88);
        if (t & 1)
            o[t >> 1] = (uint8_t)(lo | (code << 4));
        else
            lo = (uint8_t)code;
    }
}

}  // namespace

extern "C" int dsd_adpcm_enc(const float* pcm, const int* step_table,
                             const int* index_table, uint8_t* out, int S,
                             int T, cudaStream_t stream) {
    if (S < 1 || T < 2 || (T & 1)) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemcpyToSymbolAsync(
        c_step, step_table, sizeof(int) * 89, 0,
        cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbolAsync(c_index, index_table, sizeof(int) * 16, 0,
                                cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    const int threads = 64;
    adpcm_enc_kernel<<<(S + threads - 1) / threads, threads, 0, stream>>>(
        pcm, out, S, T);
    return (int)cudaGetLastError();
}
