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
// float32, where they are exact (at most 255 * 2 * n < 2^24), so integer
// metrics give its decisions bit for bit, on any uint8 input.  The
// kernel keeps the metrics less the branch cost s1 + s0 that every
// candidate of a step carries (acs below), which changes no comparison
// and no end state.
//
// What bounds it: the header path decodes a few hundred words a block,
// so the kernel is latency-bound: n dependent add-compare-select steps
// (~12 cycles each) then n traceback steps per word, far from the byte
// bound (2n + n bytes a word).  Every integer instruction issues at half
// rate (16 lanes a cycle on an SM sub-partition), so with one warp on a
// sub-partition what the warp issues sets the time: the compiled loops
// issue 196 instructions a trip of 8 forward steps and 70 a trip of 8
// traceback steps (chip_smoke.py prints them, with cuobjdump).
//
// What the first version (one thread per word, 128 to a block, rows
// read in place) lost: each thread read its own 660-byte row four bytes
// at a time (one sector a lane per load, uncoalesced, unstaged), and its
// survivors (uint32_t bp[64] indexed at run time) lived in local memory,
// so each traceback step waited on a dependent local load.
//
// Design (K5's in csrc/conv_k5.cu): one thread per word, 32 words a
// block, so 888 words take 28 SMs.  The coded bits pass through shared
// memory in chunks of 64 steps (128 bytes a row), double-buffered: for
// each of the block's rows the warp copies the 4-byte-aligned superset
// of the row's chunk with 4-byte cp.async (one row's 128 contiguous
// bytes an instruction), so an odd n or an unaligned view is copied the
// same way and read at the row's byte offset.  A thread reads its row's
// 8 steps with one 16-byte load when the rows are 4-byte aligned (a row
// pitch of 144 bytes, 16 mod 128: a quarter-warp's 16-byte reads are
// conflict-free), else byte by byte, one group ahead of the steps; the
// 8 steps of a group run in a loop, not unrolled further (a chunk
// unrolled whole ran slower, most likely past the instruction cache).
// The four metrics stay in registers; each state's add-compare-select
// is a compare, a select and a predicated or of its
// take bit into a 32-bit word per 8 steps, stored to shared memory
// ([group][word]).  The traceback loads the group's word ahead of its
// chain and turns each step's take bits into a byte table of next
// states (byte st of the table is (st >> 1) + 2 * take_b(st)), so the
// chain is one byte permute (PRMT) a step with the state as its
// selector; it writes its bits into an [32, n] byte tile over the
// staging area, which the block stores contiguous, 16 bytes at a time.
// No local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 32;          // words a block, one per thread
constexpr int kChunk = 64;          // steps a staged chunk (128 bytes a row)
constexpr int kPitch = 144;         // bytes a staged row (>= 132, 16 mod 128)
constexpr int kStages = 2;          // chunks in flight (double buffer)
constexpr int kMaxSteps = 512;

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// dynamic shared memory: the survivor words [ceil(n / 8)][kWords], then
// the staging area, which the [kWords, n] output tile overlays once the
// steps are done
__host__ __device__ constexpr int smem_bytes(int n) {
  return align16((n + 7) / 8 * kWords * 4) +
         (kStages * kWords * kPitch > align16(kWords * n)
              ? kStages * kWords * kPitch
              : align16(kWords * n));
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

// the kept metric of candidates a (from pa) and b (from pb), b only when
// strictly less, and `bit` set in take when b is kept: a compare, a
// select and a predicated or (written as a min, a select of the bit and
// an or, the compiled loop issues 230 instructions a trip of 8 steps,
// not 196)
__device__ __forceinline__ int keep(int a, int b, uint32_t& take,
                                    uint32_t bit) {
  int r;
  asm("{\n.reg .pred p;\n"
      "setp.lt.s32 p, %3, %2;\n"
      "selp.b32 %0, %3, %2, p;\n"
      "@p or.b32 %1, %1, %4;\n}\n"
      : "=r"(r), "+r"(take)
      : "r"(a), "r"(b), "r"(bit));
  return r;
}

// one add-compare-select step of the four states on inputs (s1, s0);
// its take-pb bits of the new states 0..3 go to bits shift..shift+3 of
// take.  The branch costs |s1 - e1| + |s0 - e0| of the expected pairs
// (e1, e0) are d[e1 e0]; TRANS (protocol/dstar/decoder.py _V_TRANS)
// gives
//   ns 0: (0, 00) / (2, 11)   ns 1: (0, 11) / (2, 00)
//   ns 2: (1, 10) / (3, 01)   ns 3: (1, 01) / (3, 10)
// Every candidate of the step carries d00 = s1 + s0 plus u1 for e1 = 1
// and u0 for e0 = 1, where u = |s - 1| - s = (s == 0 ? 1 : -1) for any
// uint8 s.  The kernel drops the common d00: each comparison, and the
// order of the kept metrics (so the end state), stay as they are, and
// the metrics stay within +-2n.
__device__ __forceinline__ void acs(int (&m)[4], int s1, int s0,
                                    uint32_t& take, int shift) {
  const int u1 = s1 == 0 ? 1 : -1, u0 = s0 == 0 ? 1 : -1, w = u1 + u0;
  const int n0 = keep(m[0], m[2] + w, take, 1u << shift);
  const int n1 = keep(m[0] + w, m[2], take, 2u << shift);
  const int n2 = keep(m[1] + u1, m[3] + u0, take, 4u << shift);
  const int n3 = keep(m[1] + u0, m[3] + u1, take, 8u << shift);
  m[0] = n0, m[1] = n1, m[2] = n2, m[3] = n3;
}

// the next-state table of a step's take bits: byte st holds
// (st >> 1) + 2 * take_b(st) (the multiply spreads bit j to byte j)
__device__ __forceinline__ uint32_t next_table(uint32_t take) {
  return 0x01010000u + 2u * ((take * 0x00204081u) & 0x01010101u);
}

// the eight steps of group g from its 16 staged bytes (s1, s0 pairs)
__device__ __forceinline__ uint32_t group8(int (&m)[4], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t take = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acs(m, w[q] & 0xFF, (w[q] >> 8) & 0xFF, take, 8 * q);
    acs(m, (w[q] >> 16) & 0xFF, w[q] >> 24, take, 8 * q + 4);
  }
  return take;
}

// the traceback's step: the state's byte of the step's next-state table
// (the state is the selector: its upper nibbles pick bytes never read,
// and no nibble sets the sign-replicate bit, so no mask is needed)
__device__ __forceinline__ uint32_t back(uint32_t table, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(table), "r"(sel));
  return r;
}

// kAligned: every row 4-byte aligned (n even, the input 4-byte aligned),
// so each chunk's superset is the chunk itself and a row's 8 steps are
// one 16-byte shared load
template <bool kAligned>
__global__ void __launch_bounds__(kWords)
    conv_k3_kernel(const uint8_t* __restrict__ bits,
                   uint8_t* __restrict__ out, int N, int n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ng = (n + 7) / 8;
  uint32_t* bp = reinterpret_cast<uint32_t*>(smem);
  uint8_t* stage = smem + align16(ng * kWords * 4);

  const int tid = threadIdx.x;
  const int64_t w0 = (int64_t)blockIdx.x * kWords;
  const int rows = N - w0 < kWords ? (int)(N - w0) : kWords;
  const int64_t rb = 2 * (int64_t)n;          // bytes a row
  const uint8_t* blk = bits + w0 * rb;
  const int n_chunks = (n + kChunk - 1) / kChunk;

  // chunk c of every row into buffer c % kStages: row r's words go to
  // lanes 0..nw-1 (nw <= 32 aligned, <= 33 otherwise)
  auto issue = [&](int c) {
    if (c < n_chunks) {
      uint8_t* dst = stage + (c % kStages) * kWords * kPitch;
      const uint8_t* src = blk + (int64_t)c * 2 * kChunk;
      const int64_t left = rb - (int64_t)c * 2 * kChunk;
      const int len = left < 2 * kChunk ? (int)left : 2 * kChunk;
      for (int r = 0; r < rows; ++r, dst += kPitch, src += rb) {
        const uintptr_t lo = (uintptr_t)src & ~(uintptr_t)3;
        const int nw = (int)((((uintptr_t)src + len + 3) & ~(uintptr_t)3) -
                             lo) >> 2;
        if (tid < nw) cp_async4(dst + 4 * tid, (const void*)(lo + 4 * tid));
        if (!kAligned && tid + 32 < nw)
          cp_async4(dst + 4 * (tid + 32), (const void*)(lo + 4 * (tid + 32)));
      }
    }
    cp_async_commit();
  };

  // this thread's row offset in its staged rows (0 when aligned)
  const int off = kAligned ? 0 : (int)((uintptr_t)(blk + tid * rb) & 3);
  int m[4] = {0, 0, 0, 0};
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);
    cp_async_wait<kStages - 1>();     // chunk c has landed
    __syncthreads();
    const uint8_t* rs = stage + (c % kStages) * kWords * kPitch +
                        tid * kPitch + off;
    uint32_t* bpc = bp + c * (kChunk / 8) * kWords + tid;
    const int len = min(kChunk, n - c * kChunk);
    if (kAligned && len == kChunk) {
      // the next group's 16 bytes load before this group's steps (a
      // shared load does not move across the survivor store); a loop,
      // not unrolled: the chunk's 64 steps unrolled ran slower, most
      // likely past the instruction cache
      uint4 v = *reinterpret_cast<const uint4*>(rs);
#pragma unroll 1
      for (int g = 0; g < kChunk / 8; ++g) {
        const uint4 nx =
            g + 1 < kChunk / 8
                ? *reinterpret_cast<const uint4*>(rs + 16 * (g + 1))
                : v;
        bpc[g * kWords] = group8(m, v);
        v = nx;
      }
    } else {
      for (int g = 0; 8 * g < len; ++g) {
        uint32_t take = 0;
        const int steps = min(8, len - 8 * g);
        for (int k = 0; k < steps; ++k) {
          const int j = 2 * (8 * g + k);
          acs(m, rs[j], rs[j + 1], take, 4 * k);
        }
        bpc[g * kWords] = take;
      }
    }
    __syncthreads();                  // buffer c % kStages is refilled next
  }

  // the end state: the first of least metric (no run-time index into m,
  // which would put the metrics in local memory)
  int st = 0, best = m[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (m[k] < best) st = k, best = m[k];

  // traceback into the [kWords, n] tile over the staging area; the state
  // is the byte-permute selector (its upper bytes' picks are not read)
  uint8_t* o = stage + tid * n;
  uint32_t sel = (uint32_t)st;
  int g = ng - 1;
  {
    const uint32_t w = bp[g * kWords + tid];
    for (int k = n - 8 * g - 1; k >= 0; --k) {
      o[8 * g + k] = (uint8_t)(sel & 1);
      sel = back(next_table((w >> (4 * k)) & 15), sel);
    }
  }
  uint32_t wn = g > 0 ? bp[(g - 1) * kWords + tid] : 0;
  for (--g; g >= 0; --g) {
    const uint32_t w = wn;
    if (g > 0) wn = bp[(g - 1) * kWords + tid];
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      o[8 * g + k] = (uint8_t)(sel & 1);
      sel = back(next_table((w >> (4 * k)) & 15), sel);
    }
  }
  __syncthreads();

  // the tile is contiguous in the output
  uint8_t* dst = out + w0 * n;
  const int nb = rows * n;
  int k0 = 0;
  if (((uintptr_t)dst & 15) == 0) {
    const int n16 = nb / 16;
    for (int k = tid; k < n16; k += kWords)
      reinterpret_cast<int4*>(dst)[k] =
          reinterpret_cast<const int4*>(stage)[k];
    k0 = 16 * n16;
  }
  for (int k = k0 + tid; k < nb; k += kWords) dst[k] = stage[k];
}

template <bool kAligned>
int launch(const void* bits, void* out, int N, int n, cudaStream_t stream) {
  const int grid = (N + kWords - 1) / kWords;
  conv_k3_kernel<kAligned><<<grid, kWords, smem_bytes(n), stream>>>(
      (const uint8_t*)bits, (uint8_t*)out, N, n);
  return (int)cudaGetLastError();
}

}  // namespace

// bits: [N, 2n] uint8, contiguous, any alignment; out: [N, n] uint8,
// contiguous (16-byte stores where the block's piece is 16-byte aligned)
extern "C" int dsd_conv_k3(const void* bits, void* out, int N, int n,
                           void* stream) {
  if (N <= 0 || n <= 0) return 0;
  if (n > kMaxSteps) return (int)cudaErrorInvalidValue;
  static_assert(smem_bytes(kMaxSteps) <= 48 * 1024,
                "K6's shared memory needs the opt-in attribute");
  const bool aligned = n % 2 == 0 && (uintptr_t)bits % 4 == 0;
  return aligned ? launch<true>(bits, out, N, n, (cudaStream_t)stream)
                 : launch<false>(bits, out, N, n, (cudaStream_t)stream);
}
