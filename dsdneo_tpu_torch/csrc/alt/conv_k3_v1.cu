// K6's first design (one thread per word, 128 words a block, rows read
// in place, survivors in local memory), which csrc/conv_k3.cu replaced.
// Not part of the kernels' library (kernels.py builds csrc/*.cu only):
// chip_smoke.py builds it with its own nvcc call beside the library's,
// holds it to the kernel bit for bit, times both and prints the
// instruction mix of its compiled loops.
//
// K6: the K=3 rate-1/2 hard Viterbi of the D-STAR RF header, [N, 2n]
// uint8 coded bits -> [N, n] uint8 decoded bits (n = 330 on the header).
//
// Replaces dsdneo_tpu/fec/device.py conv_k3_decode_batch (a jitted
// lax.scan over n steps of [4, N] float32 metrics, then a reverse scan
// for the traceback; the host decoder protocol/dstar/decoder._viterbi_k3
// is the same lattice).  Generators G1 = 1+D+D^2, G2 = 1+D^2; state ns
// holds the last two input bits, bit 0 the newest.  Per word:
//
//   metrics start at 0 in every state
//   step t: s1, s0 = bits[2t], bits[2t+1]; new state ns has the two
//   predecessors of TRANS[ns] = (pa, a1, a0), (pb, b1, b0):
//     ma = metric[pa] + |s1 - a1| + |s0 - a0|
//     mb = metric[pb] + |s1 - b1| + |s0 - b0|
//   pb wins only when mb < ma (a tie keeps pa = ns >> 1)
//   the end state is the first state of least metric; the traceback
//   reads bit t = state & 1 and steps to (state >> 1) + 2 * took_pb
//
// Integer arithmetic: the JAX function sums the same small integers in
// float32, where they are exact (at most 255 * 2 * n < 2^24), so int32
// metrics give its decisions bit for bit, on any uint8 input.
//
// What bounds it: the header path decodes a few hundred words per block,
// so the kernel is latency-bound (n dependent steps per thread), far
// from both the byte bound (2n + n bytes per word) and the card's
// integer rate.  Design: one thread per word; the four metrics in
// registers; the four take-pb bits of a step packed into a 32-bit word
// of backpointers per 8 steps (42 words for 330 steps, in registers or
// local memory); the coded bits read four bytes (two steps) at a time
// when the row is 4-byte aligned, and the output written as 16-bit
// pairs when it is 2-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSteps = 512;

// (pa, a1, a0, pb, b1, b0) of new state ns (protocol/dstar/decoder.py
// _V_TRANS)
__host__ __device__ constexpr int trans(int ns, int k) {
  constexpr int t[4][6] = {{0, 0, 0, 2, 1, 1},
                           {0, 1, 1, 2, 0, 0},
                           {1, 1, 0, 3, 0, 1},
                           {1, 0, 1, 3, 1, 0}};
  return t[ns][k];
}

__device__ __forceinline__ int absdiff(int s, int a) {
  return s > a ? s - a : a - s;
}

__device__ __forceinline__ void acs(int (&m)[4], int s1, int s0,
                                    uint32_t& word, int shift) {
  int nm[4];
#pragma unroll
  for (int ns = 0; ns < 4; ++ns) {
    const int ma = m[trans(ns, 0)] + absdiff(s1, trans(ns, 1)) +
                   absdiff(s0, trans(ns, 2));
    const int mb = m[trans(ns, 3)] + absdiff(s1, trans(ns, 4)) +
                   absdiff(s0, trans(ns, 5));
    const bool tb = mb < ma;
    nm[ns] = tb ? mb : ma;
    word |= (uint32_t)tb << (shift + ns);
  }
#pragma unroll
  for (int ns = 0; ns < 4; ++ns) m[ns] = nm[ns];
}

__global__ void __launch_bounds__(kThreads)
    conv_k3_kernel(const uint8_t* __restrict__ bits,
                   uint8_t* __restrict__ out, int N, int n) {
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= N) return;
  const uint8_t* row = bits + w * 2 * n;

  int m[4] = {0, 0, 0, 0};
  uint32_t bp[kMaxSteps / 8];
  const bool aligned4 = ((uintptr_t)row & 3) == 0;
  int t = 0;
  if (aligned4) {
    // two steps per 4-byte load: bytes s1, s0, s1, s0
    for (; t + 2 <= n; t += 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(row + 2 * t);
      if ((t & 7) == 0) bp[t >> 3] = 0;
      acs(m, v & 0xFF, (v >> 8) & 0xFF, bp[t >> 3], 4 * (t & 7));
      acs(m, (v >> 16) & 0xFF, v >> 24, bp[t >> 3], 4 * ((t + 1) & 7));
    }
  }
  for (; t < n; ++t) {
    if ((t & 7) == 0) bp[t >> 3] = 0;
    acs(m, row[2 * t], row[2 * t + 1], bp[t >> 3], 4 * (t & 7));
  }

  int st = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (m[k] < m[st]) st = k;

  uint8_t* o = out + w * n;
  const bool aligned2 = ((uintptr_t)o & 1) == 0 && (n & 1) == 0;
  for (int i = n - 1; i >= 0; --i) {
    const int bit = st & 1;
    const int took_b = (bp[i >> 3] >> (4 * (i & 7) + st)) & 1;
    st = (st >> 1) + 2 * took_b;
    if (aligned2 && (i & 1)) {
      // bit i now; bit i - 1 after one more step, stored as a pair
      const int i1 = i - 1;
      const int bit1 = st & 1;
      const int tb1 = (bp[i1 >> 3] >> (4 * (i1 & 7) + st)) & 1;
      st = (st >> 1) + 2 * tb1;
      *reinterpret_cast<uint16_t*>(o + i1) =
          (uint16_t)(bit1 | (bit << 8));
      --i;
    } else {
      o[i] = (uint8_t)bit;
    }
  }
}

}  // namespace

extern "C" int dsd_conv_k3(const void* bits, void* out, int N, int n,
                           void* stream) {
  if (N <= 0 || n <= 0) return 0;
  if (n > kMaxSteps) return (int)cudaErrorInvalidValue;
  const int grid = (N + kThreads - 1) / kThreads;
  conv_k3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (uint8_t*)out, N, n);
  return (int)cudaGetLastError();
}
