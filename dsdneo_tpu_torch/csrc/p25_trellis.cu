// K4: the P25 rate-1/2 trellis Viterbi, [N, 196] int32 LLRs or [N, 196]
// uint8 hard bits -> ([N, 96] uint8 data bits, [N] int32 path costs).
//
// Replaces dsdneo_tpu/fec/device.py p25_12_decode_batch (a jitted
// lax.scan over 49 steps of [4, N] metrics, then a reverse scan for the
// traceback).  Per word:
//
//   llr = (1 - 2 * bit) * 64 when the word comes as bits (as the JAX
//   function forms it when llr196 is None)
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
// What bounds it on the H100: the bytes, 784 in a word as LLRs (196 as
// bits) and 100 out: ~10 us at the P25 monitor's 38,400 words with LLRs,
// ~3.4 us as bits, ~35 us at 131,072 words with LLRs, at 3.35 TB/s.  The
// arithmetic, ~100 integer instructions a word and step, is under the
// LLRs' bytes but over the bits': in the bits form it is what the
// kernel waits on.
//
// What the first version (one thread per word, 128 to a block, rows read
// in place) lost: each step read 16 bytes at a deinterleaved offset of
// the thread's own 784-byte row, so every warp load touched 32 sectors
// with only ~9 warps on an SM to hide them; the backpointers and the
// cost table sat in local memory (the table indexed by a __constant__
// array); the traceback stored single bytes at the row stride; and the
// monitor path, which has hard bits, first wrote them out as an int32
// LLR tensor (4x the bytes) for the kernel to read back.  It ran at ~8%
// of its byte bound.
//
// Design: one thread per word (16 nibble costs and 4 four-way
// add-compare-selects a step are a thread's ILP), 32 words to a block.
// Four lanes a word (one per next state, the metrics by shuffles) repeat
// the cost sums, ~1.9x the instructions a word, and are slower at both
// of chip_smoke.py's shapes (csrc/alt/viterbi_lanes.cu, timed beside
// this kernel).  The block's rows are one
// contiguous span of 32 x 784 (or 32 x 196) bytes; the warp stages it
// in shared memory with 16-byte cp.async, coalesced, and each step
// reads its four deinterleaved values from the thread's row in shared
// memory: the row pitch of 196 words (49 for bits) puts a quarter-warp's
// 16-byte reads (a warp's 4-byte reads) on distinct banks.  Step 4q + r
// reads deperm[4r] + 4q, so the steps run as 12 groups of four unrolled
// steps (the tables compile-time constants) and a last step; a group's
// four backpointer bytes go to shared memory as one word.  Bits leave
// through an [32, 96] byte tile (row pitch 100 bytes, so the
// traceback's 4-byte stores are conflict-free) over the input tile, in
// coalesced 4-byte stores; costs leave as one coalesced 4-byte store a
// thread.  No local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 49;
constexpr int kBits = 196;
constexpr int kWords = 32;          // words per block, one per thread
constexpr int kOutBytes = 96;
constexpr int kOutPitch = 100;      // output tile row pitch: 25 words, so
                                    // a warp's 4-byte stores are
                                    // conflict-free

// deperm[j] = the received bit that lands at deinterleaved position j
// (fec/trellis.py interleave_98: deperm[2 il[i]] = 2i, deperm[2 il[i] +
// 1] = 2i + 1).  Step i reads deperm[4i .. 4i+3], which are four
// consecutive received bits starting at deperm[4i] (a multiple of 4).
__host__ __device__ constexpr int deperm4(int i) {
  constexpr int16_t c_deperm[kBits] = {
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
  return c_deperm[4 * i];
}

// P25_DTM[prev << 2 | next]: the nibble sent on the transition
__host__ __device__ constexpr int dtm(int k) {
  constexpr uint8_t c_dtm[16] = {2, 12, 1, 15, 14, 0,  13, 3,
                                 9, 7,  10, 4, 5,  11, 6,  8};
  return c_dtm[k];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// step 4q + r reads deperm[4r] + 4q: the steps go in groups of four over
// four runs of the row, and a group's offsets are compile-time constants
// plus 16q bytes of LLRs (4q of bits)
__host__ __device__ constexpr bool deperm_runs() {
  for (int i = 0; i < kSteps; ++i)
    if (deperm4(i) != deperm4(i % 4) + 4 * (i / 4)) return false;
  return true;
}
static_assert(deperm_runs(), "step 4q + r reads deperm[4r] + 4q");

// bits 0..3 of x to bytes 0..3 (each 0 or 1)
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// the four LLRs at deinterleaved position `base` of the row (bytes of
// bits if kHard, else int32 LLRs)
template <bool kHard>
__device__ __forceinline__ void load_llr(const uint8_t* row, int base,
                                         int32_t (&l)[4]) {
  if (kHard) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(row + base);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      l[k] = (1 - 2 * (int32_t)((q >> (8 * k)) & 0xff)) * 64;
  } else {
    const int4 q = *reinterpret_cast<const int4*>(row + 4 * base);
    l[0] = q.x;
    l[1] = q.y;
    l[2] = q.z;
    l[3] = q.w;
  }
}

// one step on its four LLRs: the metrics advance, and the step's
// backpointers come back as a byte, 2 bits per next state
__device__ __forceinline__ uint32_t trellis_step(const int32_t (&l)[4],
                                                 int32_t (&m)[4]) {
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
  int32_t nm[4];
  uint32_t b = 0;
#pragma unroll
  for (int nxt = 0; nxt < 4; ++nxt) {
    int32_t best = m[0] + c[dtm(nxt)];
    uint32_t arg = 0;
#pragma unroll
    for (int prev = 1; prev < 4; ++prev) {
      const int32_t v = m[prev] + c[dtm((prev << 2) | nxt)];
      if (v < best) {
        best = v;
        arg = prev;
      }
    }
    nm[nxt] = best;
    b |= arg << (2 * nxt);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = nm[k];
  return b;
}

// kHard: the input is [N, 196] uint8 bits, else [N, 196] int32 LLRs
template <bool kHard>
__global__ void __launch_bounds__(kWords)
    p25_trellis_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ bits,
                       int32_t* __restrict__ cost_out, int N) {
  constexpr int kRowBytes = kHard ? kBits : 4 * kBits;
  constexpr int kGroups = kSteps / 4;   // 12 groups of 4 steps, then one
  static_assert(kWords * kRowBytes >= kWords * kOutPitch,
                "the output tile must fit over the input tile");
  __shared__ __align__(16) uint8_t tile[kWords * kRowBytes];
  __shared__ uint32_t bps[kGroups + 1][kWords];   // backpointer bytes

  const int tid = threadIdx.x;
  const int64_t w0 = (int64_t)blockIdx.x * kWords;
  const int rows = N - w0 < kWords ? (int)(N - w0) : kWords;

  // stage the block's rows, one contiguous span starting 16-byte
  // aligned (32 rows of a multiple of 4 bytes): 16-byte pieces, then
  // the last tile's 4-byte tail
  {
    const uint8_t* src = in + w0 * kRowBytes;
    const int nb = rows * kRowBytes;
    const int n16 = nb / 16;
    for (int k = tid; k < n16; k += kWords)
      cp_async16(tile + 16 * k, src + 16 * k);
    for (int k = 4 * n16 + tid; k < nb / 4; k += kWords)
      cp_async4(tile + 4 * k, src + 4 * k);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  // the groups run as a loop, so only one step's loads are in flight
  // ahead of the step that runs (all 49 steps unrolled, the compiler
  // issues every load first and the LLR form spills)
  const uint8_t* row = tile + tid * kRowBytes;
  int32_t m[4] = {0, 256, 256, 256};
  int32_t l[4];
  load_llr<kHard>(row, deperm4(0), l);
#pragma unroll 1
  for (int q = 0; q < kGroups; ++q) {
    uint32_t w = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int32_t ln[4];   // step 4q + r + 1's, the last one step 48's
      load_llr<kHard>(row, deperm4((r + 1) % 4) + 4 * (q + (r + 1) / 4),
                      ln);
      w |= trellis_step(l, m) << (8 * r);
#pragma unroll
      for (int k = 0; k < 4; ++k) l[k] = ln[k];
    }
    bps[q][tid] = w;
  }
  bps[kGroups][tid] = trellis_step(l, m);

  // end state: the first of the minima
  int32_t best = m[0];
  int st = 0;
  if (m[1] < best) { best = m[1]; st = 1; }
  if (m[2] < best) { best = m[2]; st = 2; }
  if (m[3] < best) { best = m[3]; st = 3; }
  if (tid < rows) cost_out[w0 + tid] = best;

  // traceback: state[48] is the flush step; state[i] for i < 48 is data
  // dibit i, output bytes 2i (high bit) and 2i + 1, written four bytes
  // (two dibits) at a time into the output tile over the input tile
  __syncthreads();  // every thread is done with its input row
  uint32_t* orow = reinterpret_cast<uint32_t*>(tile + tid * kOutPitch);
  st = (bps[kGroups][tid] >> (2 * st)) & 3;
#pragma unroll 1
  for (int q = kGroups - 1; q >= 0; --q) {
    const uint32_t w = bps[q][tid];
    uint32_t word[2] = {0, 0};   // dibits 4q, 4q+1 and 4q+2, 4q+3
#pragma unroll
    for (int r = 3; r >= 0; --r) {
      const uint32_t hi_lo = ((st >> 1) & 1) | ((st & 1) << 1);
      word[r / 2] |= spread4(hi_lo << (2 * (r % 2)));
      st = (w >> (8 * r + 2 * st)) & 3;
    }
    orow[2 * q] = word[0];
    orow[2 * q + 1] = word[1];
  }
  __syncthreads();
  // the tile's rows are contiguous in the output: coalesced 4-byte stores
  constexpr int kRowWords = kOutBytes / 4;
  uint32_t* dst = reinterpret_cast<uint32_t*>(bits + w0 * kOutBytes);
  for (int k = tid; k < rows * kRowWords; k += kWords)
    dst[k] = *reinterpret_cast<const uint32_t*>(
        tile + (k / kRowWords) * kOutPitch + 4 * (k % kRowWords));
}

}  // namespace

// in: [N, 196] int32 LLRs (hard == 0) or uint8 bits (hard == 1),
// contiguous, 16-byte aligned; bits: [N, 96] uint8, 16-byte aligned;
// cost: [N] int32
extern "C" int dsd_p25_trellis(const void* in, int hard, void* bits,
                               void* cost, int N, void* stream) {
  if (N <= 0) return 0;
  const int grid = (N + kWords - 1) / kWords;
  if (hard)
    p25_trellis_kernel<true><<<grid, kWords, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)bits, (int32_t*)cost, N);
  else
    p25_trellis_kernel<false><<<grid, kWords, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)bits, (int32_t*)cost, N);
  return (int)cudaGetLastError();
}
