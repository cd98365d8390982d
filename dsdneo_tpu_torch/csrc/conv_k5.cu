// K5: the K=5 rate-1/2 weighted soft Viterbi, [N, 2n] f32 symbols and
// [N, 2n] f32 weights (or one weight row for every word) -> [N, n] uint8
// decoded bits (flush bits included; callers slice).
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
// for any input.  On hard symbols with 0/1 weights (the NXDN CAC, M17's
// stream frames) every term is an exact small integer, so it is
// bit-identical to the JAX function there too.
//
// What bounds it on the H100: by bytes, 8n bytes of symbols a word
// (plus 8n of weights when each word has its own row) in and n out:
// ~5.6 us at the NXDN monitor's [11,840, 350] with one weight row, ~58
// us at [65,536, 350] with a weight row per word, at 3.35 TB/s.  In
// practice the issue: a step is ~107 instructions a thread (16
// add-compare-selects, each two FADDs, an FSETP, an FSEL and the take
// bit's SEL and half a LOP3), and one warp already fills its SM
// sub-partition's issue (two warps on one take twice as long:
// chip_smoke.py's K5 sweep), so a warp of 32 words costs ~230 cycles a
// step, and the paths' batches (370 and 710 warps on 528
// sub-partitions) take one or two warps' time; the chain of a step (add,
// compare, select: ~12 cycles) is far under it.
//
// What the first version (one thread per word, 128 to a block, inputs
// read in place) lost: each step's loads were two 8-byte pieces per lane
// at the row stride (1,400 bytes), so every warp load touched 32
// sectors for 8 useful bytes each, with 4 warps on an SM to hide it;
// the survivors (1 KiB a thread) sat in local memory; the traceback
// stored one byte a lane at the row stride; and the wrapper copied the
// callers' broadcast weight row into an [N, 2n] tensor first.  It ran
// at 7.5-17% of its byte bound.
//
// Design: one thread per word, 32 words to a block so that small
// batches still spread over the SMs.  Sixteen lanes per word (one per
// state, two shuffles a step) and four (four states a lane) repeat the
// branch costs and add the exchange: ~3x and ~1.7x the instructions a
// word, and slower at every batch from one warp a sub-partition up
// (csrc/alt/viterbi_lanes.cu, timed beside this kernel by
// chip_smoke.py); they win only on batches that leave sub-partitions
// without a warp.  The inputs pass
// through shared memory in chunks (16 steps with one weight row, 32
// with a row per word), double-buffered: lane j of a warp copies pair
// j % chunk of its rows with 8-byte cp.async, pointers only advancing,
// so a warp copies whole contiguous row pieces and the next chunk lands
// while the steps of this one run; a thread reads its (s0, s1) and
// (w0, w1) pairs from a row of chunk + 1 pairs (an odd pitch: the
// half-warp's 8-byte reads fall on distinct banks).  A weight row stride
// of 0 (one row for all words, as the NXDN and M17 paths pass it)
// stages that row once per block.  Each step's branch costs are formed
// during the step before, its inputs loaded before that step's survivor
// store (a shared-memory load does not move across a store).  The 16
// take bits of a step go to shared memory as one uint16 per word
// ([step][word]: a warp's stores and the traceback's loads are 64
// contiguous bytes); the traceback loads eight steps' words ahead of its
// chain, writes its bits into an [32, n] byte tile over the staging
// area, and the warp stores the tile, which is contiguous in the
// output, in 16-byte pieces.  No local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 32;            // words per block, one per thread
constexpr int kStages = 2;            // chunks in flight (double buffer)
constexpr int kMaxSteps = 512;

// steps per staged chunk: 16 with one weight row (less shared memory,
// more blocks an SM), 32 with a weight row per word (each copy 256
// contiguous bytes of a row, for the doubled bytes)
__host__ __device__ constexpr int chunk_steps(bool broadcast) {
  return broadcast ? 16 : 32;
}

// pairs in one staging ring: kStages chunks of kWords rows, each row
// padded to an odd pitch of chunk + 1 pairs
__host__ __device__ constexpr int ring_pairs(bool broadcast) {
  return kStages * kWords * (chunk_steps(broadcast) + 1);
}

// O1[p][b] | O2[p][b] << 1 for state p and input bit b (fec/conv.py
// _tables: o1 = b ^ s2 ^ s3, o2 = b ^ s0 ^ s1 ^ s3)
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// dynamic shared memory: survivors [n][kWords] uint16, then the staging
// area: the symbol double buffer and the weights (one row of n pairs
// and a pad pair, or a double buffer), which the [kWords, n] output tile
// overlays once the steps are done
__host__ __device__ constexpr int smem_bytes(int n, bool broadcast) {
  const int stage = ring_pairs(broadcast) * 8 +
                    (broadcast ? align16(8 * (n + 1))
                               : ring_pairs(broadcast) * 8);
  const int tile = align16(kWords * n);
  return align16(2 * n * kWords) + (stage > tile ? stage : tile);
}

// kBroadcast: one weight row for every word (row stride 0)
template <bool kBroadcast>
__global__ void __launch_bounds__(kWords)
    conv_k5_kernel(const float2* __restrict__ sym,
                   const float2* __restrict__ wt, uint8_t* __restrict__ bits,
                   int N, int n) {
  constexpr int kChunk = chunk_steps(kBroadcast);
  constexpr int kPitch = kChunk + 1;       // pairs per staged row (odd)
  constexpr int kPass = kWords / kChunk;   // rows' chunks a warp copies
                                           // at once
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* bp = reinterpret_cast<uint16_t*>(smem);
  float2* sbuf = reinterpret_cast<float2*>(smem + align16(2 * n * kWords));
  float2* wbuf = sbuf + ring_pairs(kBroadcast);

  const int tid = threadIdx.x;
  const int64_t w0 = (int64_t)blockIdx.x * kWords;
  const int rows = N - w0 < kWords ? (int)(N - w0) : kWords;
  const float2* srow = sym + w0 * n;
  const float2* wrow = kBroadcast ? wt : wt + w0 * n;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  // chunk c's pairs of every row into buffer c % kStages: lane `tid`
  // copies pair cj of rows cr, cr + kPass, ..., so a warp copies kPass
  // rows' chunks at a time, each contiguous; its pointers only advance
  const int cj = tid % kChunk, cr = tid / kChunk;
  auto issue = [&](int c) {
    const int j0 = c * kChunk;
    if (j0 + cj < n) {   // (false past the last chunk: an empty group)
      const int off = (c % kStages) * kWords * kPitch + cr * kPitch + cj;
      float2* sd = sbuf + off;
      float2* wd = wbuf + off;
      const float2* sg = srow + (int64_t)cr * n + j0 + cj;
      const float2* wg = wrow + (int64_t)cr * n + j0 + cj;
      for (int r = cr; r < rows; r += kPass) {
        cp_async8(sd, sg);
        if (!kBroadcast) cp_async8(wd, wg);
        sd += kPass * kPitch;
        wd += kPass * kPitch;
        sg += kPass * n;
        wg += kPass * n;
      }
    }
    cp_async_commit();
  };

  if (kBroadcast)
    for (int j = tid; j < n; j += kWords) cp_async8(wbuf + j, wt + j);
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  float m[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) m[t] = t == 0 ? 0.0f : 1e30f;

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);
    cp_async_wait<kStages - 1>();   // chunk c has landed
    __syncthreads();
    const int j0 = c * kChunk;
    const int len = min(kChunk, n - j0);
    const int buf = (c % kStages) * kWords * kPitch;
    const float2* sd = sbuf + buf + tid * kPitch;
    const float2* wd = kBroadcast
                           ? wbuf + j0
                           : wbuf + buf + tid * kPitch;
    // the branch costs d[o1 | o2 << 1] = |o1 - s0| * w0 + |o2 - s1| * w1
    // of step j are formed during step j - 1, and its inputs loaded
    // before that step's survivor store (which the compiler cannot move
    // a shared-memory load across)
    auto costs = [](float2 sv, float2 wv, float (&d)[4]) {
      const float a0 = __fmul_rn(fabsf(0.0f - sv.x), wv.x);
      const float a1 = __fmul_rn(fabsf(1.0f - sv.x), wv.x);
      const float b0 = __fmul_rn(fabsf(0.0f - sv.y), wv.y);
      const float b1 = __fmul_rn(fabsf(1.0f - sv.y), wv.y);
      d[0] = __fadd_rn(a0, b0);
      d[1] = __fadd_rn(a1, b0);
      d[2] = __fadd_rn(a0, b1);
      d[3] = __fadd_rn(a1, b1);
    };
    float d[4];
    costs(sd[0], wd[0], d);
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      // one past the chunk on its last step: the row's pad pair (or the
      // weight row's), read and not used
      const float2 sn = sd[j + 1];
      const float2 wn = wd[j + 1];
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
      bp[(j0 + j) * kWords + tid] = (uint16_t)take;
      costs(sn, wn, d);
    }
    __syncthreads();  // buffer c % kStages is refilled next
  }

  // traceback into the [kWords, n] output tile over the staging area,
  // eight steps at a time: their survivor words are loaded first, so
  // the chain of state updates does not wait on each load; state st
  // goes back to (st >> 1) | 8 where pb was taken, else st >> 1
  uint8_t* tile = reinterpret_cast<uint8_t*>(sbuf);
  uint8_t* out = tile + tid * n;
  int st = 0;
  int i = n - 1;
  for (; i >= 7; i -= 8) {
    uint32_t tk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) tk[k] = bp[(i - k) * kWords + tid];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      out[i - k] = (uint8_t)(st & 1);
      st = (st >> 1) | (((tk[k] >> st) & 1) << 3);
    }
  }
  for (; i >= 0; --i) {
    const uint32_t tk = bp[i * kWords + tid];
    out[i] = (uint8_t)(st & 1);
    st = (st >> 1) | (((tk >> st) & 1) << 3);
  }
  __syncthreads();

  // the tile is contiguous in the output and starts 16-byte aligned
  // (w0 * n is a multiple of 32 * n)
  uint8_t* dst = bits + w0 * n;
  const int nb = rows * n;
  const int n16 = nb / 16;
  for (int k = tid; k < n16; k += kWords)
    reinterpret_cast<int4*>(dst)[k] = reinterpret_cast<const int4*>(tile)[k];
  for (int k = 16 * n16 + tid; k < nb; k += kWords) dst[k] = tile[k];
}

template <bool kBroadcast>
int launch(const void* sym, const void* wt, void* bits, int N, int n,
           cudaStream_t stream) {
  static int opted_in = 48 * 1024;  // bytes past which the attribute is set
  const int smem = smem_bytes(n, kBroadcast);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_k5_kernel<kBroadcast>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int grid = (N + kWords - 1) / kWords;
  conv_k5_kernel<kBroadcast><<<grid, kWords, smem, stream>>>(
      (const float2*)sym, (const float2*)wt, (uint8_t*)bits, N, n);
  return (int)cudaGetLastError();
}

}  // namespace

// sym: [N, 2n] float32, contiguous, 8-byte aligned; wt: weight rows of
// 2n float32 at a row stride of wt_row_stride elements, 0 (one row for
// every word) or 2n, 8-byte aligned; bits: [N, n] uint8, 16-byte aligned
extern "C" int dsd_conv_k5(const void* sym, const void* wt,
                           int wt_row_stride, void* bits, int N, int n,
                           void* stream) {
  if (N <= 0 || n <= 0) return 0;
  if (n > kMaxSteps || (wt_row_stride != 0 && wt_row_stride != 2 * n))
    return (int)cudaErrorInvalidValue;
  return wt_row_stride == 0
             ? launch<true>(sym, wt, bits, N, n, (cudaStream_t)stream)
             : launch<false>(sym, wt, bits, N, n, (cudaStream_t)stream);
}
