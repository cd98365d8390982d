// K5: the K=5 rate-1/2 weighted soft Viterbi, [N, 2n] f32 symbols and
// [N, 2n] f32 weights -> [N, n] uint8 decoded bits (flush bits
// included; callers slice).
//
// Replaces dsdneo_tpu/fec/device.py conv_k5_decode_batch (a jitted
// lax.scan over n steps of [16, N] metrics, then a reverse scan for the
// traceback).  Generators G1 = 1+D^3+D^4, G2 = 1+D+D^2+D^4; state t
// holds the last four input bits, bit 0 the newest.  Per word:
//
//   metric starts at 0 for state 0 and 1e30 elsewhere
//   step i: s0, s1 = sym[2i], sym[2i+1]; w0, w1 = wt[2i], wt[2i+1];
//   new state t has predecessors pa = t >> 1 and pb = (t >> 1) | 8, both
//   on input bit t & 1; a candidate from p costs
//     metric[p] + (|O1[p][t&1] - s0| * w0 + |O2[p][t&1] - s1| * w1)
//   summed in that order, and pb wins only when strictly cheaper
//   traceback from state 0 (the encoder is flushed), bit i = state & 1
//
// Float arithmetic: every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn), so nvcc cannot contract a*w0 + b*w1 into an
// FMA; the result is bit-identical to fec/device.py conv_k5_decode_plain
// for any input.  On hard symbols with 0/1 weights (the NXDN CAC) every
// term is an exact small integer, so it is bit-identical to the JAX
// function there too.
//
// Layout: one thread per word; the 16 metrics in registers (the loops
// over states are unrolled, so every index is a constant); one bit per
// state per step of backpointers (take pb or not) as a uint16 per step
// in a per-thread local array.  A step computes the four distinct
// branch costs (O1, O2 in {0, 1}) once and the 16 add-compare-selects
// from them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSteps = 512;

// O1[p][b] | O2[p][b] << 1 for state p and input bit b (fec/conv.py
// _tables: o1 = b ^ s2 ^ s3, o2 = b ^ s0 ^ s1 ^ s3)
__host__ __device__ constexpr int out_pair(int p, int b) {
  const int s0 = p & 1, s1 = (p >> 1) & 1, s2 = (p >> 2) & 1,
            s3 = (p >> 3) & 1;
  return (b ^ s2 ^ s3) | ((b ^ s0 ^ s1 ^ s3) << 1);
}

__global__ void __launch_bounds__(kThreads)
    conv_k5_kernel(const float* __restrict__ sym,
                   const float* __restrict__ wt, uint8_t* __restrict__ bits,
                   int N, int n) {
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= N) return;
  const float* s = sym + w * 2 * n;
  const float* g = wt + w * 2 * n;

  float m[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) m[t] = t == 0 ? 0.0f : 1e30f;
  uint16_t bp[kMaxSteps];

  for (int i = 0; i < n; ++i) {
    const float2 sv = *reinterpret_cast<const float2*>(s + 2 * i);
    const float2 wv = *reinterpret_cast<const float2*>(g + 2 * i);
    // d[o1 | o2 << 1] = |o1 - s0| * w0 + |o2 - s1| * w1
    const float a0 = __fmul_rn(fabsf(0.0f - sv.x), wv.x);
    const float a1 = __fmul_rn(fabsf(1.0f - sv.x), wv.x);
    const float b0 = __fmul_rn(fabsf(0.0f - sv.y), wv.y);
    const float b1 = __fmul_rn(fabsf(1.0f - sv.y), wv.y);
    const float d[4] = {__fadd_rn(a0, b0), __fadd_rn(a1, b0),
                        __fadd_rn(a0, b1), __fadd_rn(a1, b1)};
    float nm[16];
    uint32_t take = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int pa = t >> 1, pb = (t >> 1) | 8, b = t & 1;
      const float ca = __fadd_rn(m[pa], d[out_pair(pa, b)]);
      const float cb = __fadd_rn(m[pb], d[out_pair(pb, b)]);
      const bool tb = cb < ca;
      nm[t] = tb ? cb : ca;
      take |= (uint32_t)tb << t;
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) m[t] = nm[t];
    bp[i] = (uint16_t)take;
  }

  uint8_t* out = bits + w * n;
  int st = 0;
  for (int i = n - 1; i >= 0; --i) {
    out[i] = (uint8_t)(st & 1);
    st = ((bp[i] >> st) & 1) ? ((st >> 1) | 8) : (st >> 1);
  }
}

}  // namespace

extern "C" int dsd_conv_k5(const void* sym, const void* wt, void* bits,
                           int N, int n, void* stream) {
  if (N <= 0 || n <= 0) return 0;
  if (n > kMaxSteps) return (int)cudaErrorInvalidValue;
  const int grid = (N + kThreads - 1) / kThreads;
  conv_k5_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)wt, (uint8_t*)bits, N, n);
  return (int)cudaGetLastError();
}
