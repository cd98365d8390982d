// K2: IMBE inter-frame log-magnitude prediction, one warp per channel.
//
// Replaces dsdneo_tpu/vocoder/device.py _prediction_scan, a lax.scan
// over the T_n frame steps of every channel.  PyTorch has no scan, so a
// plain port is a Python loop of ~15 small launches per step; here the
// whole recurrence is one launch.  Per channel and step t, with the
// carry (p_logm[56], p_L):
//
//   k      = l * p_L / L - 1 (l = 1..56; 0 when there is no p_L)
//   pred_l = lerp(p_logm[floor k], p_logm[floor k + 1]) on l <= L,
//            minus its mean over l <= L, times PRED_DECAY
//   logm   = (T_t + pred) on l <= L
//   out    = w0 * act,  voiced bits of band min(l/3, K-1),
//            exp2(clip(logm, -4, 14)) * AMP_SCALE * act
//   carry  <- (logm, L) where act, else unchanged
//
// What bounds it on an H100: latency.  At C=320 channels and T_n=162
// steps it moves ~38 MB (11.5 us at 3.35 TB/s) and does ~73 MFLOP, but
// every step of a channel waits on the step before through p_logm.  Only
// the carry's own arithmetic may sit on that chain; everything else is
// moved off it:
//
//  - one warp per channel, WARPS channels per block (at C=320, 80 blocks
//    whose warps each own an SM sub-partition).  Lane l holds the carry
//    of harmonics l and l + 32 (the second for l < 24) in registers and
//    gathers from it with __shfl_sync; the masked sum is a 5-level
//    __shfl_xor_sync butterfly.  There is no block barrier: the warps of
//    a block share nothing but the launch;
//  - the inputs come to shared memory in chunks of 32 steps with
//    cp.async, double-buffered, so chunk j + 1 lands while the chain
//    walks chunk j.  Rows of T (224 B) and V (48 B) copy as 16-byte
//    pieces; the [C, T_n] rows of w0, L, K and act start on any 4-byte
//    boundary (c * T_n * 4) and copy 4 bytes per lane;
//  - per chunk, before the chain, with one lane per step: p_L before
//    the step (the last active L, carried across chunks; a function of L
//    and act alone) by a warp scan, w0s, and the step's interpolation for
//    all 56 harmonics (indices k0, k1 and weight frac; the division
//    l * p_L / L is here, in straight-line code with no branch, so the
//    harmonics overlap);
//  - the chain per step is then: 8 shuffles (gather), the lerp, the mask,
//    the butterfly, one __fdiv_rn by max(L, 1) (division, as the JAX
//    package divides), pred and logm, the select on act.  The next
//    step's indices, weights and T row are read from shared memory one
//    step ahead; logm goes into the T slot it replaces;
//  - after the chain, per chunk, with one lane per harmonic pair: the
//    voicing bits and amps = exp2(...) from those slots, written out.
//    No phase branches on the lane (a branch around the second harmonic
//    kept ptxas from overlapping the steps): lanes 24..31 compute on a
//    harmonic they hold and store nothing.
//
// The products and sums follow the plain version's order and rounding
// (the _rn intrinsics keep nvcc from contracting them into FMAs); the sum
// over harmonics is taken in the butterfly's order.
//
// The wrapper (vocoder/device.prediction_scan) passes contiguous inputs
// with T and V on 16-byte boundaries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 56;
constexpr int N_BANDS = 12;
constexpr int WARPS = 4;            // channels (warps) per block
constexpr int CHUNK = 32;           // steps per staged chunk, one per lane
constexpr unsigned FULL = 0xffffffffu;

// one staged chunk of a channel's inputs
struct Stage {
    float T[CHUNK * MAX_L];         // rows of 224 B; logm after the chain
    float V[CHUNK * N_BANDS];
    float w0[CHUNK];
    float act[CHUNK];
    int L[CHUNK];
    int K[CHUNK];
};

// a warp's shared memory: two stages and the current chunk's
// interpolation, by harmonic and step (rows of CHUNK + 1 words: written
// with one lane per step, read with one lane per harmonic, both without
// bank conflicts)
struct WarpSmem {
    Stage st[2];
    int ki[MAX_L][CHUNK + 1];       // k0 | k1 << 8
    float fr[MAX_L][CHUNK + 1];     // frac
    float4 step[CHUNK];             // max(L, 1), L, act, p_L before
};

constexpr int SMEM_BYTES = WARPS * (int)sizeof(WarpSmem);

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                     "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// start the copies of steps [row, row + n) of one channel into s
__device__ __forceinline__ void stage(Stage& s, const float* T,
                                      const float* V, const float* w0,
                                      const float* act, const int* L,
                                      const int* K, size_t row, int n,
                                      int lane) {
    const float4* tg = reinterpret_cast<const float4*>(T + row * MAX_L);
    float4* ts = reinterpret_cast<float4*>(s.T);
    for (int i = lane; i < n * (MAX_L / 4); i += 32)
        cp_async<16>(ts + i, tg + i);
    const float4* vg = reinterpret_cast<const float4*>(V + row * N_BANDS);
    float4* vs = reinterpret_cast<float4*>(s.V);
    for (int i = lane; i < n * (N_BANDS / 4); i += 32)
        cp_async<16>(vs + i, vg + i);
    if (lane < n) {
        cp_async<4>(&s.w0[lane], w0 + row + lane);
        cp_async<4>(&s.act[lane], act + row + lane);
        cp_async<4>(&s.L[lane], L + row + lane);
        cp_async<4>(&s.K[lane], K + row + lane);
    }
}

// k0, k1 and frac of harmonic lidx (1-based) for the step's p_L and L,
// given r = 1 / max(L, 1) rounded.  l * p_L / L is a product with r and
// one FMA correction, with no branch to a slow path as __fdiv_rn has (its
// branch kept ptxas from overlapping the harmonics); for every l, p_L
// and L in 1..56 it equals __fdiv_rn bit for bit (checked over all of
// them by tests/test_torch_fec_vocoder.py).
__device__ __forceinline__ void interp(float lidx, float plf, float lden,
                                       float r, int kmax, int& k0, int& k1,
                                       float& frac) {
    const float num = __fmul_rn(lidx, plf);
    const float q0 = __fmul_rn(num, r);
    const float q = __fmaf_rn(__fmaf_rn(-q0, lden, num), r, q0);
    const float k = (plf > 0.0f ? q : 1.0f) - 1.0f;
    k0 = min(max((int)floorf(k), 0), kmax);
    k1 = min(k0 + 1, kmax);
    frac = fminf(fmaxf(k - (float)k0, 0.0f), 1.0f);
}

// p_logm[k] from the warp's registers: harmonic k < 32 in lane k's ca,
// else in lane k - 32's cb
__device__ __forceinline__ float gather(float ca, float cb, int k) {
    const float lo = __shfl_sync(FULL, ca, k & 31);
    const float hi = __shfl_sync(FULL, cb, k & 31);
    return k < 32 ? lo : hi;
}

__device__ __forceinline__ float lerp_rn(float g0, float g1, float f) {
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), g0), __fmul_rn(f, g1));
}

__global__ void __launch_bounds__(WARPS * 32)
imbe_pred_kernel(const float* __restrict__ T, const float* __restrict__ w0,
                 const int* __restrict__ L, const int* __restrict__ K,
                 const float* __restrict__ V, const float* __restrict__ act,
                 const float* __restrict__ prev_logm,
                 const int* __restrict__ prev_L,
                 float* __restrict__ w0_out, float* __restrict__ voiced,
                 float* __restrict__ amps, float* __restrict__ f_logm,
                 int* __restrict__ f_L, int C, int Tn, float pred_decay,
                 float amp_scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c = blockIdx.x * WARPS + warp;
    if (c >= C) return;
    WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem_raw)[warp];

    // harmonic lane + 32 exists; lanes past it compute on harmonic lane's
    // slot (offset ob) and store nothing
    const bool hb = lane < MAX_L - 32;
    const int ob = hb ? 32 + lane : lane;
    const float la = (float)(lane + 1), lb = (float)(lane + 33);
    const int ba = lane / 3, bb = (lane + 32) / 3;   // voicing bands
    float ca = prev_logm[(size_t)c * MAX_L + lane];
    float cb = hb ? prev_logm[(size_t)c * MAX_L + 32 + lane] : 0.0f;
    int pL = prev_L[c];

    const size_t base = (size_t)c * Tn;
    const int n_chunks = (Tn + CHUNK - 1) / CHUNK;
    if (n_chunks > 0)
        stage(sm.st[0], T, V, w0, act, L, K, base, min(CHUNK, Tn), lane);
    cp_async_commit();

    for (int j = 0; j < n_chunks; ++j) {
        const int t0 = j * CHUNK;
        const int n = min(CHUNK, Tn - t0);
        const size_t row = base + t0;
        if (j + 1 < n_chunks)
            stage(sm.st[(j + 1) & 1], T, V, w0, act, L, K, row + CHUNK,
                  min(CHUNK, Tn - t0 - CHUNK), lane);
        cp_async_commit();
        cp_async_wait_prior();                 // chunk j has landed
        __syncwarp();
        Stage& s = sm.st[j & 1];

        // (1) one lane per step: p_L before the step, by a scan of the
        // last active L; w0s; then (2) the step's interpolation for every
        // harmonic
        {
            const bool valid = lane < n;
            const float a = valid ? s.act[lane] : 0.0f;
            const int Lt = valid ? s.L[lane] : 0;
            int last = (valid && a > 0.0f) ? Lt : -1;
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(FULL, last, o);
                if (lane >= o && last < 0) last = u;
            }
            int before = __shfl_up_sync(FULL, last, 1);
            if (lane == 0 || before < 0) before = pL;
            const int end = __shfl_sync(FULL, last, 31);
            if (end >= 0) pL = end;
            const float lden = fmaxf((float)Lt, 1.0f);
            const float plf = (float)before;
            sm.step[lane] = make_float4(lden, (float)Lt, a, plf);
            if (valid) w0_out[row + lane] = __fmul_rn(s.w0[lane], a);

            const float r = __frcp_rn(lden);
            const int kmax = max(before - 1, 0);
#pragma unroll 8
            for (int h = 0; h < MAX_L; ++h) {
                int k0, k1;
                float frac;
                interp((float)(h + 1), plf, lden, r, kmax, k0, k1, frac);
                sm.ki[h][lane] = k0 | k1 << 8;
                sm.fr[h][lane] = frac;
            }
        }
        __syncwarp();

        // (3) the chain; step t + 1's operands are read during step t
        int ka = sm.ki[lane][0], kb = sm.ki[ob][0];
        float fa = sm.fr[lane][0], fb = sm.fr[ob][0];
        float4 st = sm.step[0];
        float Ta = s.T[lane], Tb = s.T[ob];
        for (int t = 0; t < n; ++t) {
            const int tn = min(t + 1, n - 1);
            const int kan = sm.ki[lane][tn], kbn = sm.ki[ob][tn];
            const float fan = sm.fr[lane][tn], fbn = sm.fr[ob][tn];
            const float4 stn = sm.step[tn];
            const float Tan = s.T[tn * MAX_L + lane];
            const float Tbn = s.T[tn * MAX_L + ob];

            const float ma = la <= st.y ? 1.0f : 0.0f;
            const float mb = (hb && lb <= st.y) ? 1.0f : 0.0f;
            const float pva = __fmul_rn(lerp_rn(gather(ca, cb, ka & 0xff),
                                                 gather(ca, cb, ka >> 8), fa),
                                         ma);
            const float pvb = __fmul_rn(lerp_rn(gather(ca, cb, kb & 0xff),
                                                 gather(ca, cb, kb >> 8), fb),
                                         mb);
            float sum = __fadd_rn(pva, pvb);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
            const float pmean = __fdiv_rn(sum, st.x);
            const bool has_prev = st.w > 0.0f;
            const float pa = __fmul_rn(
                __fmul_rn(pred_decay, __fsub_rn(pva, pmean)), ma);
            const float pb = __fmul_rn(
                __fmul_rn(pred_decay, __fsub_rn(pvb, pmean)), mb);
            const float lma = __fmul_rn(__fadd_rn(Ta, has_prev ? pa : 0.0f),
                                        ma);
            const float lmb = __fmul_rn(__fadd_rn(Tb, has_prev ? pb : 0.0f),
                                        mb);
            if (st.z > 0.0f) {
                ca = lma;
                cb = lmb;
            }
            s.T[t * MAX_L + lane] = lma;
            if (hb) s.T[t * MAX_L + 32 + lane] = lmb;
            ka = kan;
            kb = kbn;
            fa = fan;
            fb = fbn;
            st = stn;
            Ta = Tan;
            Tb = Tbn;
        }
        __syncwarp();

        // (4) one lane per harmonic pair: voicing bits, and amps from the
        // chain's logm
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
            const float4 q = sm.step[t];
            const int km1 = s.K[t] - 1;
            const float* vt = s.V + t * N_BANDS;
            const size_t o = (row + t) * MAX_L;
            const float ma = la <= q.y ? 1.0f : 0.0f;
            const float mb = lb <= q.y ? 1.0f : 0.0f;
            const float va = __fmul_rn(
                __fmul_rn(vt[max(min(ba, km1), 0)], ma), q.z);
            const float vb = __fmul_rn(
                __fmul_rn(vt[max(min(bb, km1), 0)], mb), q.z);
            const float lma = fminf(fmaxf(s.T[t * MAX_L + lane], -4.0f),
                                    14.0f);
            const float lmb = fminf(fmaxf(s.T[t * MAX_L + ob], -4.0f), 14.0f);
            const float ama = __fmul_rn(
                __fmul_rn(__fmul_rn(exp2f(lma), ma), amp_scale), q.z);
            const float amb = __fmul_rn(
                __fmul_rn(__fmul_rn(exp2f(lmb), mb), amp_scale), q.z);
            voiced[o + lane] = va;
            amps[o + lane] = ama;
            if (hb) voiced[o + 32 + lane] = vb;
            if (hb) amps[o + 32 + lane] = amb;
        }
        __syncwarp();                          // stage j & 1 free again
    }
    f_logm[(size_t)c * MAX_L + lane] = ca;
    if (hb) f_logm[(size_t)c * MAX_L + 32 + lane] = cb;
    if (lane == 0) f_L[c] = pL;
}

}  // namespace

extern "C" int dsd_imbe_pred(const float* T, const float* w0, const int* L,
                             const int* K, const float* V, const float* act,
                             const float* prev_logm, const int* prev_L,
                             float* w0_out, float* voiced, float* amps,
                             float* f_logm, int* f_L, int C, int Tn,
                             float pred_decay, float amp_scale,
                             cudaStream_t stream) {
    if (C < 1 || Tn < 0) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        imbe_pred_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    imbe_pred_kernel<<<(C + WARPS - 1) / WARPS, WARPS * 32, SMEM_BYTES,
                       stream>>>(T, w0, L, K, V, act, prev_logm, prev_L,
                                 w0_out, voiced, amps, f_logm, f_L, C, Tn,
                                 pred_decay, amp_scale);
    return (int)cudaGetLastError();
}
