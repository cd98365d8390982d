// K7: Reed-Solomon syndromes over GF(2^6), [N, n] int32 symbol words
// -> [N, nroots] int32 syndromes, on the tensor cores' 1-bit product.
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
// so there the kernel's latency after its launch is what counts.
//
// Design: the syndromes are GF(2)-linear in a word's 6n bits.  Bit b of
// symbol j adds alpha^(b + (n-1-j)(fcr+i)) to S_i, so bit o of S_i is the
// parity of the AND of the word's bits with column (i, o) of a fixed 0/1
// matrix H.  mma.m16n8k256 .b1 .and.popc counts those ANDs for 16 words
// and 8 columns over 256 bits in one instruction; the count's low bit is
// the parity.
//   K index:   dword M = 2 b + h holds bit b of symbols 32 h .. 32 h + 31
//              of a word (zero past n): 12 dwords, two k-steps of 8, the
//              last 4 dwords zero;
//   N index:   an n-tile is output bit o of a group of 8 roots, column g
//              root 8 q + g, so lane (g, t4) of the D fragment collects
//              all six bits of the syndromes of roots 8 q + 2 t4 and
//              8 q + 2 t4 + 1 for words g and g + 8 in its own registers;
//   H:         uint2 tab[group q][bit o][k-step][lane], the B fragments
//              in the order lanes read them, built on the host once per
//              (n, nroots, fcr) (fec/device.k7_table), 3 KB a group.
// A block of 4 warps takes 16 words.  Warp w loads its group's 24 B
// fragments (12 coalesced 8-byte loads) before anything else, then
// words 4w .. 4w + 3, lane t holding symbols t and 32 + t of a word, and
// turns each into its 12 dwords with one __ballot_sync each; the dwords
// go through shared memory to the A fragments, and warp w runs 6 bits x
// 2 k-steps mma for root groups w, w + 4, ... and stores each lane's
// syndromes straight from its registers (8-byte stores when nroots is
// even).  Any nroots >= 1 and fcr >= 0 (they only shape H).
//
// What holds it back (chip_smoke.py prints the SASS): a warp issues
// ~300 instructions for a 16-word block (the 48 ballots with a shift and
// a compare each; the group loop, 119 around its 12 mma; loads, stores
// and set-up), ~75 warp instructions a word, so at 20,480 words the
// issue is ~1.5 us on the card's 528 sub-partitions, below the measured
// time; the rest is each block's chain of two global round trips, a
// barrier and dependent mma pairs.  With a few thousand words every
// block is resident at once and that chain is the kernel's time after
// launch.
//
// What the earlier designs lost (all in csrc/alt/, built and timed
// beside this one by chip_smoke.py): the first (rs_syndromes_v1.cu, a
// warp per word, a lane per root) walked the 63 symbols with two
// dependent shared loads and a branch a step, ~9 instructions a symbol a
// root for one word; the bit-sliced GF(2) design (rs_syndromes_v2.cu,
// 32 words' bits transposed into planes, Horner's rule with the
// multiplication by beta as 36 AND-XORs) spent 36 logic instructions a
// symbol a root for 32 words on the logic pipe, ~2,300 warp
// instructions for 32 words at RS(63,35).  Here the whole product of 16
// words is 12 tensor-core instructions a group of 8 roots, 48 at 28
// roots, and the bits are made by 12 ballots a word.  The same product
// on int8 mma.m16n8k32 (rs_syndromes_mma.cu, a byte a bit, 84 KiB of B
// fragments for RS(63,35)) needs 7 x the tensor-core instructions (336
// for 16 words at 28 roots) and reads its table from L2 in every block;
// it is slower than the bit-sliced design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWords = 16;               // words a block: one m16 tile
constexpr int kPer = kWords / kWarps;    // words a warp stages
constexpr int kDw = 20;   // dwords a staged word (16 used): lane (g, t4)
                          // reads bank 20 g + t4 + const, all different

__device__ __forceinline__ void bmma(int (&d)[4], const uint32_t (&a)[4],
                                     const uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// group q's B fragments: bf[o][s] is lane's (dword 8 s + t4, dword
// 8 s + 4 + t4) of column g of n-tile (q, o)
__device__ __forceinline__ void load_group(const uint2* __restrict__ tab,
                                           int q, int lane,
                                           uint2 (&bf)[6][2]) {
  const uint2* tb = tab + (size_t)q * 12 * 32 + lane;
#pragma unroll
  for (int k = 0; k < 12; ++k) bf[k >> 1][k & 1] = __ldg(tb + 32 * k);
}

__global__ void __launch_bounds__(kThreads)
rs_syndromes_kernel(const int32_t* __restrict__ words,
                    const uint2* __restrict__ tab,
                    int32_t* __restrict__ out, int N, int n, int nroots) {
  __shared__ __align__(16) uint32_t s_dw[kWords * kDw];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t w0 = (int64_t)blockIdx.x * kWords;
  const int nw = (int)min((int64_t)kWords, (int64_t)N - w0);
  const int ngroups = (nroots + 7) >> 3;

  uint2 bf[6][2];
  if (warp < ngroups) load_group(tab, warp, lane, bf);

  // the bit dwords of this warp's words
  {
    int32_t lo[kPer], hi[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int w = warp * kPer + r;
      const int32_t* src = words + (w0 + w) * n;
      lo[r] = (w < nw && lane < n) ? __ldg(src + lane) : 0;
      hi[r] = (w < nw && 32 + lane < n) ? __ldg(src + 32 + lane) : 0;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      uint32_t d[12];
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        d[2 * b] = __ballot_sync(0xffffffffu, lo[r] & (1 << b));
        d[2 * b + 1] = __ballot_sync(0xffffffffu, hi[r] & (1 << b));
      }
      if (lane == 0) {
        uint4* row = reinterpret_cast<uint4*>(s_dw + (warp * kPer + r) * kDw);
        row[0] = make_uint4(d[0], d[1], d[2], d[3]);
        row[1] = make_uint4(d[4], d[5], d[6], d[7]);
        row[2] = make_uint4(d[8], d[9], d[10], d[11]);
        row[3] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  __syncthreads();

  // A fragments of k-step s: words g and g + 8, dwords 8 s + t4 and
  // 8 s + 4 + t4
  uint32_t a[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t* r0 = s_dw + g * kDw + 8 * s + t4;
    const uint32_t* r1 = r0 + 8 * kDw;
    a[s][0] = r0[0];
    a[s][1] = r1[0];
    a[s][2] = r0[4];
    a[s][3] = r1[4];
  }

  const bool pairs = !(nroots & 1) && !((uintptr_t)out & 7);
  for (int q = warp; q < ngroups; q += kWarps) {
    if (q != warp) load_group(tab, q, lane, bf);
    // syndromes of (word g, root i0), (g, i0 + 1), (g + 8, i0), (g + 8,
    // i0 + 1)
    const int i0 = 8 * q + 2 * t4;
    uint32_t syn[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      int acc[4] = {0, 0, 0, 0};
      bmma(acc, a[0], bf[o][0]);
      bmma(acc, a[1], bf[o][1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) syn[c] |= (uint32_t)(acc[c] & 1) << o;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = 8 * h + g;
      if (w >= nw) continue;
      int32_t* dst = out + (w0 + w) * nroots + i0;
      if (pairs && i0 < nroots) {
        *reinterpret_cast<int2*>(dst) =
            make_int2((int)syn[2 * h], (int)syn[2 * h + 1]);
      } else {
        if (i0 < nroots) dst[0] = (int32_t)syn[2 * h];
        if (i0 + 1 < nroots) dst[1] = (int32_t)syn[2 * h + 1];
      }
    }
  }
}

}  // namespace

// tab: H's B fragments for (n, nroots, fcr), [ceil(nroots / 8)][6][2][32]
// uint2 (fec/device.k7_table)
extern "C" int dsd_rs_syndromes(const void* words, const void* tab,
                                void* out, int N, int n, int nroots,
                                void* stream) {
  if (N <= 0) return 0;
  if (n < 1 || n > 63 || nroots < 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((int64_t)N + kWords - 1) / kWords);
  rs_syndromes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const uint2*)tab, (int32_t*)out, N, n, nroots);
  return (int)cudaGetLastError();
}
