// K7's bit-sliced design, which csrc/rs_syndromes.cu (the same GF(2)
// product on the tensor cores' 1-bit mma) replaced.  Not part of the
// kernels' library (kernels.py builds csrc/*.cu only): chip_smoke.py
// builds it with its own nvcc call beside the library's, holds it to the
// kernel bit for bit and times both in the same call.  Its C entry takes
// (words, exp table, out, N, n, nroots, fcr, stream).
//
// K7: Reed-Solomon syndromes over GF(2^6), [N, n] int32 symbol words
// -> [N, nroots] int32 syndromes.
//
// Replaces dsdneo_tpu/fec/device.py _rs_syndrome_fn (a jitted
// lax.fori_loop over the roots, behind rs_syndromes_batch).  For word w
// of length n <= 63 and root i, with beta_i = alpha^(fcr + i):
//
//   S_i = sum over j of r_j * beta_i^(n-1-j)
//
// (r[0] is the coefficient of the highest degree; GF(2^6) addition is
// XOR).  The arithmetic is exact GF(2), so the result is bit-identical to
// the JAX function and to the plain version in fec/device.py.
//
// What bounds it on an H100: bytes, N * (n + nroots) * 4 (each symbol
// read once, each syndrome written once).  20,480 words of RS(63,35)
// move 7.5 MB, 2.2 us at 3.35 TB/s.  The P25 Phase 2 ESS screen at 320
// channels gives it ~2,330 words a block (0.25 us), less than a launch,
// so there the kernel's latency after its launch is what counts.  The
// work itself is logic: per 32 words, nroots x n steps of a 6x6 GF(2)
// product, 36 AND-XORs each; logic instructions issue at half rate (16
// lanes a cycle on an SM sub-partition), so at 20,480 words that alone
// is ~2.8 us of issue, above the byte bound.
//
// What the first design (rs_syndromes_v1.cu: a warp per word,
// a lane per root) lost: each root walked the 63 symbols with two
// dependent shared loads a step (the symbol's log, then the exp table at
// log + exponent) behind a branch on a zero symbol, ~9 instructions a
// symbol a root for ONE word, with 4 of 32 lanes idle at 28 roots and the
// 28 lanes' table reads on unrelated banks; the staging divided by n and
// gathered a log for every symbol.
//
// Design: bit-sliced GF(2) arithmetic.  Multiplication by a constant of
// GF(2^6) is linear over GF(2) on a symbol's six bits, a 6x6 0/1 matrix,
// so 32 words go through it at once when their bits are transposed into
// planes: plane (j, b) is a 32-bit word whose bit l is bit b of word l's
// symbol j.  A block of 4 warps takes 32 words:
//   1. staging: the words' 32 * n contiguous int32 symbols (8,064 bytes
//      at n = 63) go to shared memory with 16-byte cp.async over their
//      16-byte-aligned superset, so a view that is not 16-byte aligned
//      takes the same path and is read at its offset; in the same
//      cp.async group, the field's 64-entry exp table;
//   2. transpose: lane l packs five of word l's symbols into one 32-bit
//      word (row stride n: free of bank conflicts for odd n) and a 32x32
//      bit transpose of five shuffle stages (a shuffle, a funnel-shift
//      rotate and one LOP3 each) leaves lane k holding plane (5g + k / 6,
//      k % 6) of the 32 words, 30 planes a transpose; a warp runs its
//      four transposes side by side;
//   3. syndromes: the word is front-padded with zero symbols to 4 chunks
//      of L = ceil(n / 4) (zeros in front change no syndrome), one chunk
//      a warp, and lane l of every warp owns root r0 + l.  Its chunk runs
//      Horner's rule on planes, acc <- M_beta * acc ^ p_j, the 36 entries
//      of M_beta held as 0 / ~0 masks in registers, so a step is 36
//      AND-XORs (LOP3) and two broadcast shared loads; warp 0 then joins
//      the four chunks by Horner's rule over them with M_(beta^L).  Column
//      b of M_(alpha^e) is alpha^(e+b) (alpha = 2: alpha^b is bit b), six
//      reads of the staged exp table; each lane builds its masks itself:
//      a table of every root's matrices (8 KB), staged by every block,
//      took longer than Horner itself, every block reading the same few
//      L2 lines;
//   4. output: the same bit transpose backwards turns five roots' six
//      planes into lane w's five syndromes of word w, through a shared
//      tile to coalesced stores.
// Roots go in rounds of 32 (one lane each), so any nroots >= 1 works.
//
// What holds it back (chip_smoke.py prints the SASS): the logic pipe.
// Horner's 36 LOP3 a step for each of 28 roots over 64 padded symbols is
// 2,304 warp instructions for 32 words, ~4,600 cycles of one
// sub-partition's 16-lane logic pipe; at 20,480 words ~4.85 blocks share
// an SM, ~2.8 us at 1.98 GHz before the transposes, the staging and the
// stores.  A block alone on its SM (the ESS path's ~73 blocks) waits in
// turn on the staging, the transposes, 16 Horner steps behind its
// sub-partition's logic pipe, the join and the stores, with a barrier
// between each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 32;              // words a block: a plane's bits
constexpr int kChunks = 4;              // symbol chunks, one a warp
constexpr int kThreads = 32 * kChunks;
constexpr int kMaxN = 63;
constexpr int kMaxChunk = (kMaxN + kChunks - 1) / kChunks;   // 16
constexpr int kSyms = kChunks * kMaxChunk;                   // 64
constexpr int kMat = 36;                // masks a matrix
constexpr int kQ1 = 63;                 // multiplicative group order
constexpr int kTile = 33;               // output tile row stride (odd)
constexpr int kGroups = (kSyms + 4) / 5;                     // 13
constexpr int kGroupsPerWarp = (kGroups + kChunks - 1) / kChunks;  // 4

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 32x32 bit transposes across the warp, G of them side by side:
// afterwards bit l of lane k's word is bit k of lane l's.  Stage s swaps
// the off-diagonal s x s blocks of every 2s x 2s block: the lane whose
// bit s is clear keeps the low halves (mask m) and takes its partner's
// low halves shifted up, the other keeps the high halves and takes its
// partner's high halves shifted down.  A rotate stands in for either
// shift: the bits it wraps around land where the mask drops them.
template <int G>
__device__ __forceinline__ void transpose32(uint32_t (&x)[G], int lane) {
  const uint32_t kMask[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const bool hi = lane & s;
    const uint32_t keep = hi ? ~kMask[k] : kMask[k];
    const int rot = hi ? 32 - s : s;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t y = __shfl_xor_sync(0xffffffffu, x[g], s);
      const uint32_t t = __funnelshift_l(y, y, rot);
      x[g] = (x[g] & keep) | (t & ~keep);
    }
  }
}

// acc <- M * acc ^ p over 32 words, M as masks m[6 o + b] (0 or ~0):
// output plane o is p[o] XOR the input planes b whose entry (o, b) is 1
__device__ __forceinline__ void gf2_mul_add(uint32_t a[6],
                                            const uint32_t m[kMat],
                                            const uint32_t p[6]) {
  uint32_t t[6];
#pragma unroll
  for (int o = 0; o < 6; ++o) {
    uint32_t x = p[o];
#pragma unroll
    for (int b = 0; b < 6; ++b) x ^= a[b] & m[6 * o + b];
    t[o] = x;
  }
#pragma unroll
  for (int o = 0; o < 6; ++o) a[o] = t[o];
}

// the 36 masks of M_(alpha^e), 0 <= e < 63: column b is alpha^(e+b), entry
// (o, b) its bit o, spread to all 32 bits
__device__ __forceinline__ void build_masks(const int32_t* s_exp, int e,
                                            uint32_t m[kMat]) {
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    const int k = e + b < kQ1 ? e + b : e + b - kQ1;
    const uint32_t c = (uint32_t)s_exp[k];
#pragma unroll
    for (int o = 0; o < 6; ++o)
      m[6 * o + b] = (uint32_t)((int32_t)(c << (31 - o)) >> 31);
  }
}

__global__ void __launch_bounds__(kThreads)
rs_syndromes_kernel(const int32_t* __restrict__ words,
                    const int32_t* __restrict__ exp_t,
                    int32_t* __restrict__ out, int N, int n, int nroots,
                    int fcr) {
  // the block's words from their 16-byte-aligned start (+ 3 ints of
  // head); once the planes are made, the output tile [32][kTile]
  __shared__ __align__(16) int32_t s_w[kWords * kMaxN + 4];
  // planes [padded symbol][b], 8 words a symbol (6 used)
  __shared__ __align__(16) uint32_t s_p[kSyms][8];
  // alpha^k, k < 64
  __shared__ __align__(16) int32_t s_exp[64];
  // a round's chunk results [chunk][plane][root]; chunk 0 takes the sum.
  // Row stride 37: step 4's lane k reads plane k % 6 of root k / 6, bank
  // 5 (k % 6) + k / 6 + const, all different
  __shared__ uint32_t s_red[kChunks][6][37];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * kWords;
  const int nw = (int)min((int64_t)kWords, (int64_t)N - w0);

  // 1. staging
  const int32_t* src = words + w0 * n;
  const int head = (int)(((uintptr_t)src >> 2) & 3);
  const int32_t* lo = src - head;
  const int nvec = (head + nw * n + 3) >> 2;
  for (int k = tid; k < nvec; k += kThreads)
    cp_async16(s_w + 4 * k, lo + 4 * k);
  if (tid < 16) cp_async16(s_exp + 4 * tid, exp_t + 4 * tid);
  cp_async_wait_all();
  __syncthreads();

  // 2. planes, five padded symbols (30 planes) a transpose
  const int L = (n + kChunks - 1) / kChunks;
  const int ns = kChunks * L;               // padded symbols
  const int pad = ns - n;                   // zero symbols in front
  const int32_t* mine = s_w + head + lane * n;
  const int kq = lane / 6, kb = lane - 6 * kq;
  {
    uint32_t x[kGroupsPerWarp];
#pragma unroll
    for (int g = 0; g < kGroupsPerWarp; ++g) {
      const int j0 = 5 * (warp + kChunks * g) - pad;
      x[g] = 0;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int j = j0 + t;
        if (j >= 0 && j < n && lane < nw)
          x[g] |= (uint32_t)(mine[j] & 63) << (6 * t);
      }
    }
    transpose32<kGroupsPerWarp>(x, lane);
#pragma unroll
    for (int g = 0; g < kGroupsPerWarp; ++g) {
      const int row = 5 * (warp + kChunks * g) + kq;
      if (lane < 30 && row < ns) s_p[row][kb] = x[g];
    }
  }
  __syncthreads();

  int32_t* tile = s_w;
  for (int r0 = 0; r0 < nroots; r0 += 32) {
    const int R = min(32, nroots - r0);
    // 3. Horner on this warp's chunk, a root a lane: beta = alpha^e
    const int e = (fcr % kQ1 + (r0 + lane) % kQ1) % kQ1;
    uint32_t m[kMat];
    if (lane < R) {
      build_masks(s_exp, e, m);
      uint32_t a[6] = {0u, 0u, 0u, 0u, 0u, 0u};
      const uint32_t* pl = &s_p[warp * L][0];
#pragma unroll 4
      for (int k = 0; k < L; ++k, pl += 8) {
        const uint4 q = *reinterpret_cast<const uint4*>(pl);
        const uint2 r = *reinterpret_cast<const uint2*>(pl + 4);
        const uint32_t p[6] = {q.x, q.y, q.z, q.w, r.x, r.y};
        gf2_mul_add(a, m, p);
      }
#pragma unroll
      for (int o = 0; o < 6; ++o) s_red[warp][o][lane] = a[o];
    }
    __syncthreads();
    // the chunks joined: S = ((acc_0 b^L + acc_1) b^L + acc_2) b^L + acc_3
    if (warp == 0 && lane < R) {
      build_masks(s_exp, e * L % kQ1, m);
      uint32_t a[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint32_t p[6] = {s_red[c][0][lane], s_red[c][1][lane],
                               s_red[c][2][lane], s_red[c][3][lane],
                               s_red[c][4][lane], s_red[c][5][lane]};
        gf2_mul_add(a, m, p);
      }
#pragma unroll
      for (int o = 0; o < 6; ++o) s_red[0][o][lane] = a[o];
    }
    __syncthreads();
    // 4. five roots a transpose back to words: lane k holds plane k % 6
    // of root 5q + k / 6; after the transpose lane w holds word w's five
    // syndromes; warp y takes q = y and y + 4
    {
      uint32_t x[2];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int i = 5 * (warp + kChunks * g) + kq;
        x[g] = (lane < 30 && i < R) ? s_red[0][kb][i] : 0u;
      }
      transpose32<2>(x, lane);
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int t = 0; t < 5; ++t) {
          const int i = 5 * (warp + kChunks * g) + t;
          if (i < R) tile[lane * kTile + i] = (int32_t)((x[g] >> (6 * t)) & 63);
        }
    }
    __syncthreads();
    // element e of the round's [nw, R] tile: word e / R, root e % R (the
    // float quotient is exact for e < 32 R <= 1,024)
    const float inv = 1.0f / (float)R;
    int32_t* orow = out + w0 * nroots + r0;
    for (int e = tid; e < nw * R; e += kThreads) {
      const int w = (int)(((float)e + 0.5f) * inv);
      const int i = e - w * R;
      orow[(int64_t)w * nroots + i] = tile[w * kTile + i];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dsd_rs_syndromes(const void* words, const void* exp_t,
                                void* out, int N, int n, int nroots, int fcr,
                                void* stream) {
  if (N <= 0) return 0;
  if (n < 1 || n > kMaxN || nroots < 1 || fcr < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)(((int64_t)N + kWords - 1) / kWords);
  rs_syndromes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)exp_t, (int32_t*)out, N, n,
      nroots, fcr);
  return (int)cudaGetLastError();
}
