// K4: the P25 rate-1/2 trellis Viterbi, [N, 196] int32 LLRs ->
// ([N, 96] uint8 data bits, [N] int32 path costs).
//
// Replaces dsdneo_tpu/fec/device.py p25_12_decode_batch (a jitted
// lax.scan over 49 steps of [4, N] metrics, then a reverse scan for the
// traceback).  Per word:
//
//   llr'[j] = llr[deperm[j]]                       (deinterleave, 196)
//   step i (0..48) takes llr'[4i..4i+3]; the cost of nibble v is the sum
//   over its 4 bits of max(llr', 0) where the bit is 1, max(-llr', 0)
//   where it is 0
//   metric starts at (0, 256, 256, 256); new[nxt] = min over prev 0..3
//   of metric[prev] + cost[P25_DTM[prev << 2 | nxt]], prev taken in
//   order and replaced only by a strictly smaller value (the first
//   minimum, as np.argmin and the JAX select chain take it)
//   end state: the first of the four minima; its metric is the cost
//   traceback: state[48] = end, state[i-1] = backpointer[i][state[i]];
//   the 48 data dibits are state[0..47], high bit first
//
// Integer arithmetic throughout: bit-identical to the JAX function and
// to fec/device.py p25_12_decode_plain.
//
// Layout: one thread per word.  The four metrics live in registers; the
// 49 steps' backpointers (2 bits x 4 states = one byte per step) in a
// per-thread local array; the deinterleave map and the trellis's
// transition table in __constant__ memory, read with one address per
// warp per step (every lane is at the same step).  The LLR rows are
// read in place, 16 bytes per load (step i reads four consecutive
// source LLRs, see below); N words of 784 bytes in, 100 bytes out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 49;
constexpr int kBits = 196;
constexpr int kThreads = 128;

// deperm[j] = the received bit that lands at deinterleaved position j
// (fec/trellis.py interleave_98: deperm[2 il[i]] = 2i, deperm[2 il[i] +
// 1] = 2i + 1).  Step i reads deperm[4i .. 4i+3], which are four
// consecutive received bits starting at deperm[4i] (a multiple of 4).
__constant__ int16_t c_deperm[kBits] = {
    0,   1,   2,   3,   52,  53,  54,  55,  100, 101, 102, 103, 148, 149,
    150, 151, 4,   5,   6,   7,   56,  57,  58,  59,  104, 105, 106, 107,
    152, 153, 154, 155, 8,   9,   10,  11,  60,  61,  62,  63,  108, 109,
    110, 111, 156, 157, 158, 159, 12,  13,  14,  15,  64,  65,  66,  67,
    112, 113, 114, 115, 160, 161, 162, 163, 16,  17,  18,  19,  68,  69,
    70,  71,  116, 117, 118, 119, 164, 165, 166, 167, 20,  21,  22,  23,
    72,  73,  74,  75,  120, 121, 122, 123, 168, 169, 170, 171, 24,  25,
    26,  27,  76,  77,  78,  79,  124, 125, 126, 127, 172, 173, 174, 175,
    28,  29,  30,  31,  80,  81,  82,  83,  128, 129, 130, 131, 176, 177,
    178, 179, 32,  33,  34,  35,  84,  85,  86,  87,  132, 133, 134, 135,
    180, 181, 182, 183, 36,  37,  38,  39,  88,  89,  90,  91,  136, 137,
    138, 139, 184, 185, 186, 187, 40,  41,  42,  43,  92,  93,  94,  95,
    140, 141, 142, 143, 188, 189, 190, 191, 44,  45,  46,  47,  96,  97,
    98,  99,  144, 145, 146, 147, 192, 193, 194, 195, 48,  49,  50,  51};

// P25_DTM[prev << 2 | next]: the nibble sent on the transition
__constant__ uint8_t c_dtm[16] = {2, 12, 1, 15, 14, 0,  13, 3,
                                  9, 7,  10, 4, 5,  11, 6,  8};

__global__ void __launch_bounds__(kThreads)
    p25_trellis_kernel(const int32_t* __restrict__ llr,
                       uint8_t* __restrict__ bits,
                       int32_t* __restrict__ cost_out, int N) {
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= N) return;
  const int32_t* row = llr + w * kBits;

  int32_t m0 = 0, m1 = 256, m2 = 256, m3 = 256;
  uint8_t bp[kSteps];
#pragma unroll 7
  for (int i = 0; i < kSteps; ++i) {
    // the four deinterleaved LLRs of step i: consecutive in the row
    const int4 q = *reinterpret_cast<const int4*>(row + c_deperm[4 * i]);
    const int32_t l[4] = {q.x, q.y, q.z, q.w};
    int32_t pos[4], neg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pos[k] = l[k] > 0 ? l[k] : 0;
      neg[k] = l[k] < 0 ? -l[k] : 0;
    }
    // cost of nibble v: bit k of v (msb first) picks pos or neg
    int32_t c[16];
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      c[v] = ((v & 8) ? pos[0] : neg[0]) + ((v & 4) ? pos[1] : neg[1]) +
             ((v & 2) ? pos[2] : neg[2]) + ((v & 1) ? pos[3] : neg[3]);
    }
    const int32_t m[4] = {m0, m1, m2, m3};
    int32_t nm[4];
    uint32_t b = 0;
#pragma unroll
    for (int nxt = 0; nxt < 4; ++nxt) {
      int32_t best = m[0] + c[c_dtm[nxt]];
      uint32_t arg = 0;
#pragma unroll
      for (int prev = 1; prev < 4; ++prev) {
        const int32_t v = m[prev] + c[c_dtm[(prev << 2) | nxt]];
        if (v < best) {
          best = v;
          arg = prev;
        }
      }
      nm[nxt] = best;
      b |= arg << (2 * nxt);
    }
    m0 = nm[0];
    m1 = nm[1];
    m2 = nm[2];
    m3 = nm[3];
    bp[i] = (uint8_t)b;
  }

  // end state: the first of the minima
  int32_t best = m0;
  int st = 0;
  if (m1 < best) { best = m1; st = 1; }
  if (m2 < best) { best = m2; st = 2; }
  if (m3 < best) { best = m3; st = 3; }
  cost_out[w] = best;

  // traceback: state[48] is the flush step; state[i] for i < 48 is data
  // dibit i
  uint8_t* out = bits + w * 96;
  st = (bp[kSteps - 1] >> (2 * st)) & 3;
  for (int i = kSteps - 2; i >= 0; --i) {
    out[2 * i] = (uint8_t)((st >> 1) & 1);
    out[2 * i + 1] = (uint8_t)(st & 1);
    st = (bp[i] >> (2 * st)) & 3;
  }
}

}  // namespace

extern "C" int dsd_p25_trellis(const void* llr, void* bits, void* cost,
                               int N, void* stream) {
  if (N <= 0) return 0;
  const int grid = (N + kThreads - 1) / kThreads;
  p25_trellis_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)llr, (uint8_t*)bits, (int32_t*)cost, N);
  return (int)cudaGetLastError();
}
