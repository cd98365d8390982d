// K7 on the int8 tensor cores, a design that lost to csrc/rs_syndromes.cu
// (the same GF(2) product on the 1-bit mma).  Not part of the kernels'
// library (kernels.py builds csrc/*.cu only): chip_smoke.py builds it
// with its own nvcc call beside the library's, holds it to the kernel
// bit for bit and times both in the same call.
//
// Reed-Solomon syndromes over GF(2^6) as the GF(2) product
// bits(words) @ H, [N, n] int32 symbols -> [N, nroots] int32 syndromes.
// Bit b of symbol j adds alpha^(b + (n-1-j)(fcr+i)) to S_i, so bit o of
// S_i is the parity of the word's bits against column (i, o) of a fixed
// 0/1 matrix H; an integer product of 0/1 bytes followed by "& 1" gives
// it (the sums stay below 384).  The host builds H once per (n, nroots,
// fcr) in the B-fragment order of mma.m16n8k32 (k7_mma_table in
// chip_smoke.py), so fcr enters only through it:
//   K index:   bit b, then symbol j, zero-padded to JP = 32 or 64
//              symbols: K = 6 JP, a k-step of 32 is one bit of 32
//              symbols, and an A fragment is (4 staged symbol bytes
//              >> b) & 0x01010101, one shift and one AND;
//   N index:   root i, then output bit o, 8 columns a root (6 used), so
//              an n-tile is one root and its 6 bits meet in one lane
//              group of 4 after two shuffles;
//   layout:    uint2 tab[root (padded to 28)][k-step][lane].
// A block of 4 warps takes 16 words (one m16 tile): the words' symbols
// are staged as bytes, each warp owns 7 roots of a pass of 28 and runs
// 7 roots x (6 JP / 32) mma, its A fragments built once a k-step and its
// B fragments read through L1 from L2 (84 KiB for RS(63,35), the same
// for every block): 336 mma for 16 words at 28 roots, against the 1-bit
// kernel's 48.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRootsPerWarp = 7;
constexpr int kRootsPerPass = kWarps * kRootsPerWarp;   // 28
constexpr int kTiles = 1;       // m16 word tiles a block
constexpr int kWords = 16 * kTiles;
constexpr int kRowBytes = 80;   // staged symbols a word (64 used); a row
                                // stride of 20 banks: lane (g, t) reads
                                // bank 20 g + t + const, all different
constexpr int kTile = kRootsPerPass + 1;

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

template <int SPB>   // k-steps a bit: JP / 32
__global__ void __launch_bounds__(kThreads)
rs_syndromes_mma_kernel(const int32_t* __restrict__ words,
                        const uint2* __restrict__ tab,
                        int32_t* __restrict__ out, int N, int n,
                        int nroots) {
  constexpr int KS = 6 * SPB;
  __shared__ __align__(16) uint8_t s_sym[kWords * kRowBytes];
  __shared__ int32_t s_out[kWords * kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t w0 = (int64_t)blockIdx.x * kWords;
  const int nw = (int)min((int64_t)kWords, (int64_t)N - w0);

  // staging: a warp takes kWords / 4 words, a lane a symbol, as bytes
#pragma unroll
  for (int r = 0; r < kWords / kWarps; ++r) {
    const int w = warp * (kWords / kWarps) + r;
    const int32_t* src = words + (w0 + w) * n;
#pragma unroll
    for (int h = 0; h < SPB; ++h) {
      const int j = 32 * h + lane;
      s_sym[w * kRowBytes + j] =
          (w < nw && j < n) ? (uint8_t)__ldg(src + j) : (uint8_t)0;
    }
  }
  __syncthreads();

  // this lane's symbols: rows g and g + 8 of each tile, bytes
  // 16 q + 4 t4 .. + 3
  uint32_t sym[kTiles][2][2 * SPB];
#pragma unroll
  for (int rt = 0; rt < kTiles; ++rt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < 2 * SPB; ++q)
        sym[rt][hh][q] = *reinterpret_cast<const uint32_t*>(
            s_sym + (16 * rt + 8 * hh + g) * kRowBytes + 16 * q + 4 * t4);

  for (int p0 = 0; p0 < nroots; p0 += kRootsPerPass) {
    const int rb = p0 + warp * kRootsPerWarp;
    const uint2* tb = tab + (size_t)rb * KS * 32 + lane;
    int acc[kRootsPerWarp][kTiles][4];
#pragma unroll
    for (int r = 0; r < kRootsPerWarp; ++r)
#pragma unroll
      for (int rt = 0; rt < kTiles; ++rt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][rt][c] = 0;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int b = s / SPB, q = 2 * (s % SPB);
      uint32_t a[kTiles][4];
#pragma unroll
      for (int rt = 0; rt < kTiles; ++rt) {
        a[rt][0] = (sym[rt][0][q] >> b) & 0x01010101u;
        a[rt][1] = (sym[rt][1][q] >> b) & 0x01010101u;
        a[rt][2] = (sym[rt][0][q + 1] >> b) & 0x01010101u;
        a[rt][3] = (sym[rt][1][q + 1] >> b) & 0x01010101u;
      }
#pragma unroll
      for (int r = 0; r < kRootsPerWarp; ++r) {
        const uint2 bf = __ldg(tb + (r * KS + s) * 32);
#pragma unroll
        for (int rt = 0; rt < kTiles; ++rt) mma_u8(acc[r][rt], a[rt], bf);
      }
    }
    // lane (g, t4) holds bits 2 t4, 2 t4 + 1 of rows g and g + 8: the
    // four lanes of a group OR them into one syndrome a row
#pragma unroll
    for (int r = 0; r < kRootsPerWarp; ++r)
#pragma unroll
      for (int rt = 0; rt < kTiles; ++rt) {
        uint32_t x = (uint32_t)((acc[r][rt][0] & 1) | (acc[r][rt][1] & 1) << 1
                                | (acc[r][rt][2] & 1) << 8
                                | (acc[r][rt][3] & 1) << 9)
                     << (2 * t4);
        x |= __shfl_xor_sync(0xffffffffu, x, 1);
        x |= __shfl_xor_sync(0xffffffffu, x, 2);
        if (t4 == 0) {
          const int col = warp * kRootsPerWarp + r;
          s_out[(16 * rt + g) * kTile + col] = (int32_t)(x & 63);
          s_out[(16 * rt + g + 8) * kTile + col] = (int32_t)((x >> 8) & 63);
        }
      }
    __syncthreads();
    // the pass's [nw, R] tile, coalesced (the float quotient is exact
    // for e < 16 R <= 448)
    const int R = min(kRootsPerPass, nroots - p0);
    const float inv = 1.0f / (float)R;
    int32_t* orow = out + w0 * nroots + p0;
    for (int e = tid; e < nw * R; e += kThreads) {
      const int w = (int)(((float)e + 0.5f) * inv);
      const int i = e - w * R;
      orow[(int64_t)w * nroots + i] = s_out[w * kTile + i];
    }
    __syncthreads();
  }
}

}  // namespace

// tab: the B fragments of H for (n, nroots, fcr), nroots padded up to a
// multiple of 28
extern "C" int dsd_rs_syndromes_mma(const void* words, const void* tab,
                                    void* out, int N, int n, int nroots,
                                    void* stream) {
  if (N <= 0) return 0;
  if (n < 1 || n > 63 || nroots < 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((int64_t)N + kWords - 1) / kWords);
  if (n <= 32)
    rs_syndromes_mma_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (const uint2*)tab, (int32_t*)out, N, n,
        nroots);
  else
    rs_syndromes_mma_kernel<2><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (const uint2*)tab, (int32_t*)out, N, n,
        nroots);
  return (int)cudaGetLastError();
}
