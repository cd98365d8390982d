// K7's first design (one warp per word, a lane per root, each root a
// walk over the word's logs through a shared exp table), which
// csrc/rs_syndromes.cu replaced.  Not part of the kernels' library
// (kernels.py builds csrc/*.cu only): chip_smoke.py builds it with its
// own nvcc call beside the library's, holds it to the kernel bit for bit
// and times both in the same call.  Its C entry keeps the first
// design's arguments (words, exp table, log table, out, N, n, nroots,
// fcr, stream).
//
// K7: Reed-Solomon syndromes over GF(2^6), [N, n] int32 symbol words
// -> [N, nroots] int32 syndromes.
//
// Replaces dsdneo_tpu/fec/device.py _rs_syndrome_fn (a jitted
// lax.fori_loop over the roots, behind rs_syndromes_batch).  For word w
// of length n <= 63 and root i:
//
//   S_i = XOR over j with w_j != 0 of exp[(log w_j + (n-1-j)(fcr+i)) mod 63]
//
// (r[0] is the coefficient of the highest degree; GF(2^6) addition is
// XOR).  Integer table arithmetic: the result is bit-identical to the
// JAX function and to the plain version in fec/device.py.
//
// What bounds it on an H100: bytes, at most.  The P25 Phase 2 ESS
// screen gives it a few hundred words per block (N * 63 * 4 bytes in,
// N * nroots * 4 out, ~0.1 us at 3.35 TB/s), so a launch costs its
// launch; at 20,480 words it moves 7.5 MB (2.2 us).  The design is the
// simple one: a block of 8 warps takes 8 words; the warps stage the
// words' symbols as logs (with a zero flag) and the 128-entry exp table
// in shared memory, then lane l of warp y computes roots l, l+32, ...
// of word y.  A root's sum walks the 63 symbols with its exponent
// stepped down by (fcr + i) mod 63 per symbol, so no multiply or modulo
// sits in the loop, and log + exponent < 126 indexes the doubled exp
// table directly.  The 63 table reads of a root are independent; only
// the XOR chains them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ1 = 63;                 // multiplicative group order
constexpr int kWordsPerBlock = 8;       // one warp per word
constexpr int kMaxN = 63;

__global__ void rs_syndromes_kernel(const int32_t* __restrict__ words,
                                    const int32_t* __restrict__ exp_t,
                                    const int32_t* __restrict__ log_t,
                                    int32_t* __restrict__ out, int N, int n,
                                    int nroots, int fcr) {
  __shared__ int32_t s_exp[2 * (kQ1 + 1)];
  __shared__ int32_t s_log[kWordsPerBlock][kMaxN];   // -1 for a zero
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int k = tid; k < 2 * (kQ1 + 1); k += 32 * kWordsPerBlock)
    s_exp[k] = exp_t[k];
  const int64_t w0 = (int64_t)blockIdx.x * kWordsPerBlock;
  for (int k = tid; k < kWordsPerBlock * n; k += 32 * kWordsPerBlock) {
    const int y = k / n, j = k - y * n;
    int v = 0;
    if (w0 + y < N) v = words[(w0 + y) * n + j];
    s_log[y][j] = v ? log_t[v] : -1;
  }
  __syncthreads();

  const int64_t word = w0 + threadIdx.y;
  if (word >= N) return;
  const int32_t* lw = s_log[threadIdx.y];
  for (int i = threadIdx.x; i < nroots; i += 32) {
    const int step = (fcr + i) % kQ1;
    int e = ((n - 1) * step) % kQ1;     // exponent of symbol 0
    int acc = 0;
    for (int j = 0; j < n; ++j) {
      const int lg = lw[j];
      if (lg >= 0) acc ^= s_exp[lg + e];
      e -= step;
      if (e < 0) e += kQ1;
    }
    out[word * nroots + i] = acc;
  }
}

}  // namespace

extern "C" int dsd_rs_syndromes(const void* words, const void* exp_t,
                                const void* log_t, void* out, int N, int n,
                                int nroots, int fcr, void* stream) {
  if (N <= 0) return 0;
  if (n < 1 || n > kMaxN || nroots < 1 || fcr < 0)
    return (int)cudaErrorInvalidValue;
  dim3 block(32, kWordsPerBlock);
  dim3 grid((N + kWordsPerBlock - 1) / kWordsPerBlock);
  rs_syndromes_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)exp_t, (const int32_t*)log_t,
      (int32_t*)out, N, n, nroots, fcr);
  return (int)cudaGetLastError();
}
