// K5 and K4 with several lanes per word: the designs that lost to the
// shipped kernels (csrc/conv_k5.cu, csrc/p25_trellis.cu, one thread per
// word).  Not part of the kernels' library (kernels.py builds csrc/*.cu
// only): chip_smoke.py builds this file with its own nvcc call, holds
// its output to the shipped kernels' bit for bit, and times both on the
// same inputs at the paths' shapes, so the choice is measured again on
// every run.
//
// K5 (the same function as csrc/conv_k5.cu): L = 16 gives each state a
// lane (256 threads, 16 words a block): m[t >> 1] and m[(t >> 1) | 8]
// come by two __shfl_sync(width 16), the lane forms the two branch costs
// it needs, d[x] and d[x ^ 3] with x = out_pair(t >> 1, t & 1) (input
// bit and s3 each flip both outputs), and a __ballot_sync gives the
// step's 16 take bits per word.  L = 4 gives lane l states 4l..4l+3
// (128 threads, 32 words a block): the four metrics go through shared
// memory (one float4 out, the pairs 2l, 2l + 1 and 2l + 8, 2l + 9 back),
// and four ballots a step hold the take bits.  The inputs are staged as
// in the shipped kernel (32-step chunks, double-buffered 8-byte
// cp.async; a stride-0 weight row once a block).
//
// K4 (the same function as csrc/p25_trellis.cu): four lanes a word, one
// per next state (128 threads, 32 words a block), each forming the four
// nibble costs it needs as sum(neg) + sum(bit * llr), every lane keeping
// the four metrics (four __shfl_sync(width 4) a step); the block's rows
// staged as in the shipped kernel.
//
// Why they lose on the H100 (chip_smoke.py's K4/K5 lines): one warp of
// the thread-per-word kernels fills its SM sub-partition's issue, so
// wherever every sub-partition has a warp the time follows the
// instructions a word and step, and the lanes repeat the branch costs
// and add the exchange: ~20 instructions a lane and step at L = 16
// (~10 warp instructions a word against ~3.3), ~46 at L = 4, ~48 for K4
// (~1.9x the thread's a word).  Only where the batch leaves
// sub-partitions without a warp do more lanes pay.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int out_pair(int p, int b) {
  const int s0 = p & 1, s1 = (p >> 1) & 1, s2 = (p >> 2) & 1,
            s3 = (p >> 3) & 1;
  return (b ^ s2 ^ s3) | ((b ^ s0 ^ s1 ^ s3) << 1);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

constexpr int kStages = 2;
constexpr int kChunk = 32;

// threads per block for L lanes a word
__host__ __device__ constexpr int k5_threads(int L) {
  return L == 16 ? 256 : 128;
}

template <int L>
__host__ __device__ constexpr int k5_words() {
  return k5_threads(L) / L;
}

template <int L>
__host__ __device__ constexpr int k5_ring() {
  return kStages * k5_words<L>() * (kChunk + 1);
}

template <int L>
__host__ __device__ constexpr int k5_smem(int n, bool bc) {
  constexpr int W = k5_words<L>();
  const int stage = k5_ring<L>() * 8 +
                    (bc ? align16(8 * (n + 1)) : k5_ring<L>() * 8);
  const int tile = align16(W * n);
  return align16(2 * n * W) + (stage > tile ? stage : tile);
}

// L = 16: lane t of a half-warp holds state t; L = 4: lane l of a quad
// holds states 4l..4l+3, exchanged through shared memory
template <int L, bool kBc>
__global__ void __launch_bounds__(k5_threads(L))
    k5_lanes(const float2* __restrict__ sym, const float2* __restrict__ wt,
             uint8_t* __restrict__ bits, int N, int n) {
  constexpr int T = k5_threads(L);
  constexpr int W = T / L;
  constexpr int kPitch = kChunk + 1;
  constexpr int kPass = T / kChunk;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* bp = reinterpret_cast<uint32_t*>(smem);   // [n][W / 2]
  float2* sbuf = reinterpret_cast<float2*>(smem + align16(2 * n * W));
  float2* wbuf = sbuf + k5_ring<L>();
  __shared__ __align__(16) float xch[L == 4 ? T / 32 : 1][2][8][16];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int word = tid / L;
  const int64_t w0 = (int64_t)blockIdx.x * W;
  const int rows = N - w0 < W ? (int)(N - w0) : W;
  const float2* srow = sym + w0 * n;
  const float2* wrow = kBc ? wt : wt + w0 * n;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  const int cj = tid % kChunk, cr = tid / kChunk;
  auto issue = [&](int c) {
    const int j0 = c * kChunk;
    if (j0 + cj < n) {
      const int off = (c % kStages) * W * kPitch + cr * kPitch + cj;
      float2* sd = sbuf + off;
      float2* wd = wbuf + off;
      const float2* sg = srow + (int64_t)cr * n + j0 + cj;
      const float2* wg = wrow + (int64_t)cr * n + j0 + cj;
      for (int r = cr; r < rows; r += kPass) {
        cp_async8(sd, sg);
        if (!kBc) cp_async8(wd, wg);
        sd += kPass * kPitch;
        wd += kPass * kPitch;
        sg += kPass * n;
        wg += kPass * n;
      }
    }
    cp_async_commit();
  };
  if (kBc)
    for (int j = tid; j < n; j += T) cp_async8(wbuf + j, wt + j);
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  // per-lane constants
  float m[L == 16 ? 1 : 4];
  int x0;
  int src_a = 0, src_b = 0;
  if constexpr (L == 16) {
    const int t = lane & 15;
    x0 = out_pair(t >> 1, t & 1);
    m[0] = t == 0 ? 0.0f : 1e30f;
    src_a = t >> 1;
    src_b = (t >> 1) | 8;
  } else {
    const int l = lane & 3;
    x0 = out_pair(2 * l, 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = (l == 0 && k == 0) ? 0.0f : 1e30f;
  }
  const float af = (float)(x0 & 1), naf = 1.0f - af;
  const float bf = (float)(x0 >> 1), nbf = 1.0f - bf;

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int j0 = c * kChunk;
    const int len = min(kChunk, n - j0);
    const int buf = (c % kStages) * W * kPitch;
    const float2* sd = sbuf + buf + word * kPitch;
    const float2* wd = kBc ? wbuf + j0 : wbuf + buf + word * kPitch;
#pragma unroll 2
    for (int j = 0; j < len; ++j) {
      const float2 sv = sd[j];
      const float2 wv = wd[j];
      const float Aa = __fmul_rn(fabsf(af - sv.x), wv.x);
      const float An = __fmul_rn(fabsf(naf - sv.x), wv.x);
      const float Bb = __fmul_rn(fabsf(bf - sv.y), wv.y);
      const float Bn = __fmul_rn(fabsf(nbf - sv.y), wv.y);
      if constexpr (L == 16) {
        const float da = __fadd_rn(Aa, Bb);    // d[x0]
        const float db = __fadd_rn(An, Bn);    // d[x0 ^ 3]
        const float ma = __shfl_sync(0xffffffffu, m[0], src_a, 16);
        const float mb = __shfl_sync(0xffffffffu, m[0], src_b, 16);
        const float ca = __fadd_rn(ma, da);
        const float cb = __fadd_rn(mb, db);
        const bool tb = cb < ca;
        m[0] = tb ? cb : ca;
        const uint32_t take = __ballot_sync(0xffffffffu, tb);
        if (lane == 0) bp[(j0 + j) * (W / 2) + warp] = take;
      } else {
        const float e = __fadd_rn(Aa, Bb);     // d[x0]
        const float f = __fadd_rn(An, Bn);     // d[x0 ^ 3]
        const float g = __fadd_rn(Aa, Bn);     // d[x0 ^ 2]
        const float h = __fadd_rn(An, Bb);     // d[x0 ^ 1]
        float* xb = &xch[warp][(j0 + j) & 1][lane >> 2][0];
        reinterpret_cast<float4*>(xb)[lane & 3] =
            make_float4(m[0], m[1], m[2], m[3]);
        __syncwarp();
        const float2 X = reinterpret_cast<const float2*>(xb)[lane & 3];
        const float2 Y = reinterpret_cast<const float2*>(xb)[(lane & 3) + 4];
        const float da[4] = {e, f, g, h}, db[4] = {f, e, h, g};
        uint32_t tk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float ma = k < 2 ? X.x : X.y;
          const float mb = k < 2 ? Y.x : Y.y;
          const float ca = __fadd_rn(ma, da[k]);
          const float cb = __fadd_rn(mb, db[k]);
          const bool tb = cb < ca;
          m[k] = tb ? cb : ca;
          tk[k] = __ballot_sync(0xffffffffu, tb);
        }
        const uint32_t v = lane == 0 ? tk[0] : lane == 1 ? tk[1]
                           : lane == 2 ? tk[2] : tk[3];
        if (lane < 4) bp[((j0 + j) * (W / 8) + warp) * 4 + lane] = v;
      }
    }
    __syncthreads();
  }

  uint8_t* tile = reinterpret_cast<uint8_t*>(sbuf);
  if (tid < rows) {
    uint8_t* out = tile + tid * n;
    int st = 0;
    if constexpr (L == 16) {
      const int sh = 16 * (tid & 1);
      const uint32_t* b = bp + (tid >> 1);
      for (int i = n - 1; i >= 0; --i) {
        const uint32_t tk = b[i * (W / 2)] >> sh;
        out[i] = (uint8_t)(st & 1);
        st = (st >> 1) | (((tk >> st) & 1) << 3);
      }
    } else {
      const int sh = 4 * (tid & 7);
      const uint4* b = reinterpret_cast<const uint4*>(bp) + (tid >> 3);
      for (int i = n - 1; i >= 0; --i) {
        const uint4 q = b[i * (W / 8)];
        // state 4l + k at bit 4k + l
        const uint32_t tk = ((q.x >> sh) & 15) | (((q.y >> sh) & 15) << 4) |
                            (((q.z >> sh) & 15) << 8) |
                            (((q.w >> sh) & 15) << 12);
        out[i] = (uint8_t)(st & 1);
        const int pos = ((st & 3) << 2) | (st >> 2);
        st = (st >> 1) | (((tk >> pos) & 1) << 3);
      }
    }
  }
  __syncthreads();
  uint8_t* dst = bits + w0 * n;
  const int nb = rows * n;
  const int n16 = nb / 16;
  for (int k = tid; k < n16; k += T)
    reinterpret_cast<int4*>(dst)[k] = reinterpret_cast<const int4*>(tile)[k];
  for (int k = 16 * n16 + tid; k < nb; k += T) dst[k] = tile[k];
}

template <int L, bool kBc>
int k5_launch(const void* sym, const void* wt, void* bits, int N, int n,
              cudaStream_t s) {
  static int opted = 48 * 1024;
  const int smem = k5_smem<L>(n, kBc);
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        k5_lanes<L, kBc>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  constexpr int W = k5_words<L>();
  const int grid = (N + W - 1) / W;
  k5_lanes<L, kBc><<<grid, k5_threads(L), smem, s>>>(
      (const float2*)sym, (const float2*)wt, (uint8_t*)bits, N, n);
  return (int)cudaGetLastError();
}

// -- K4, four lanes a word ---------------------------------------------------
constexpr int kSteps = 49;
constexpr int kBits = 196;
constexpr int kOutBytes = 96;
constexpr int kOutPitch = 100;

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
__host__ __device__ constexpr int dtm(int k) {
  constexpr uint8_t c_dtm[16] = {2, 12, 1, 15, 14, 0,  13, 3,
                                 9, 7,  10, 4, 5,  11, 6,  8};
  return c_dtm[k];
}
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

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
    l[0] = q.x; l[1] = q.y; l[2] = q.z; l[3] = q.w;
  }
}

constexpr int k4W = 32;             // words a block
constexpr int k4T = 4 * k4W;        // 128 threads

template <bool kHard>
__global__ void __launch_bounds__(k4T)
    k4_lanes(const uint8_t* __restrict__ in, uint8_t* __restrict__ bits,
             int32_t* __restrict__ cost_out, int N) {
  constexpr int kRowBytes = kHard ? kBits : 4 * kBits;
  constexpr int kGroups = kSteps / 4;
  __shared__ __align__(16) uint8_t tile[k4W * kRowBytes];
  __shared__ __align__(4) uint8_t bps[kGroups + 1][k4W][4];
  __shared__ int32_t fin[k4W][2];

  const int tid = threadIdx.x;
  const int nxt = tid & 3, word = tid >> 2;
  const int64_t w0 = (int64_t)blockIdx.x * k4W;
  const int rows = N - w0 < k4W ? (int)(N - w0) : k4W;
  {
    const uint8_t* src = in + w0 * kRowBytes;
    const int nb = rows * kRowBytes;
    const int n16 = nb / 16;
    for (int k = tid; k < n16; k += k4T)
      cp_async16(tile + 16 * k, src + 16 * k);
    for (int k = 4 * n16 + tid; k < nb / 4; k += k4T)
      cp_async4(tile + 4 * k, src + 4 * k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // nibble of prev p -> nxt: bit k (msb first) multiplies l[k]
  int32_t mb[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int v = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) v = q == nxt ? dtm((p << 2) | q) : v;
#pragma unroll
    for (int k = 0; k < 4; ++k) mb[p][k] = (v >> (3 - k)) & 1;
  }
  const uint8_t* row = tile + word * kRowBytes;
  int32_t m[4] = {0, 256, 256, 256};
  const int qbase = tid & ~3 & 31;
  auto step = [&](const int32_t (&l)[4]) -> uint32_t {
    int32_t neg = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) neg += l[k] < 0 ? -l[k] : 0;
    int32_t best = 0;
    uint32_t arg = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      int32_t c = neg;
#pragma unroll
      for (int k = 0; k < 4; ++k) c += mb[p][k] * l[k];
      const int32_t v = m[p] + c;
      if (p == 0 || v < best) {
        best = v;
        arg = p;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = __shfl_sync(0xffffffffu, best, qbase | k);
    return arg;
  };
  int32_t l[4];
  load_llr<kHard>(row, deperm4(0), l);
#pragma unroll 1
  for (int q = 0; q < kGroups; ++q) {
    uint32_t w = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int32_t ln[4];
      load_llr<kHard>(row, deperm4((r + 1) % 4) + 4 * (q + (r + 1) / 4),
                      ln);
      w |= step(l) << (2 * r);
#pragma unroll
      for (int k = 0; k < 4; ++k) l[k] = ln[k];
    }
    bps[q][word][nxt] = (uint8_t)w;
  }
  bps[kGroups][word][nxt] = (uint8_t)step(l);
  if (nxt == 0) {
    int32_t best = m[0];
    int st = 0;
    if (m[1] < best) { best = m[1]; st = 1; }
    if (m[2] < best) { best = m[2]; st = 2; }
    if (m[3] < best) { best = m[3]; st = 3; }
    fin[word][0] = best;
    fin[word][1] = st;
  }
  __syncthreads();
  if (tid < rows) {
    cost_out[w0 + tid] = fin[tid][0];
    int st = fin[tid][1];
    uint32_t* orow = reinterpret_cast<uint32_t*>(tile + tid * kOutPitch);
    st = bps[kGroups][tid][st] & 3;
    for (int q = kGroups - 1; q >= 0; --q) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(bps[q][tid]);
      uint32_t wd[2] = {0, 0};
#pragma unroll
      for (int r = 3; r >= 0; --r) {
        const uint32_t hi_lo = ((st >> 1) & 1) | ((st & 1) << 1);
        wd[r / 2] |= spread4(hi_lo << (2 * (r % 2)));
        st = (w >> (8 * st + 2 * r)) & 3;
      }
      orow[2 * q] = wd[0];
      orow[2 * q + 1] = wd[1];
    }
  }
  __syncthreads();
  constexpr int kRowWords = kOutBytes / 4;
  uint32_t* dst = reinterpret_cast<uint32_t*>(bits + w0 * kOutBytes);
  for (int k = tid; k < rows * kRowWords; k += k4T)
    dst[k] = *reinterpret_cast<const uint32_t*>(
        tile + (k / kRowWords) * kOutPitch + 4 * (k % kRowWords));
}

}  // namespace

// L: 16 or 4 lanes a word; the rest as dsd_conv_k5
extern "C" int dsd_conv_k5_lanes(int L, const void* sym, const void* wt,
                                 int stride, void* bits, int N, int n,
                                 void* stream) {
  if (N <= 0 || n <= 0) return 0;
  if (n > 512 || (stride != 0 && stride != 2 * n) || (L != 16 && L != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 16)
    return stride == 0 ? k5_launch<16, true>(sym, wt, bits, N, n, s)
                       : k5_launch<16, false>(sym, wt, bits, N, n, s);
  return stride == 0 ? k5_launch<4, true>(sym, wt, bits, N, n, s)
                     : k5_launch<4, false>(sym, wt, bits, N, n, s);
}

// as dsd_p25_trellis
extern "C" int dsd_p25_trellis_lanes(const void* in, int hard, void* bits,
                                     void* cost, int N, void* stream) {
  if (N <= 0) return 0;
  const int grid = (N + k4W - 1) / k4W;
  cudaStream_t s = (cudaStream_t)stream;
  if (hard)
    k4_lanes<true><<<grid, k4T, 0, s>>>((const uint8_t*)in, (uint8_t*)bits,
                                        (int32_t*)cost, N);
  else
    k4_lanes<false><<<grid, k4T, 0, s>>>((const uint8_t*)in, (uint8_t*)bits,
                                         (int32_t*)cost, N);
  return (int)cudaGetLastError();
}
