// K2: IMBE inter-frame log-magnitude prediction, one channel per block.
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
// What bounds it on an H100: nothing but latency.  At C=320 channels and
// T_n=162 steps it moves ~25 MB and does ~10 MFLOP; each step is a
// dependent chain (gather from the carry -> block mean -> update).  The
// design gives each channel one block of 64 threads, one per harmonic
// (56 active), keeps the carry in shared memory for the whole loop, and
// reduces the mean with warp shuffles, so a step costs two barriers and
// a handful of coalesced 224-byte row reads and writes; the 320 blocks
// run side by side on the 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_L = 56;
constexpr int N_BANDS = 12;
constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
imbe_pred_kernel(const float* __restrict__ T, const float* __restrict__ w0,
                 const int* __restrict__ L, const int* __restrict__ K,
                 const float* __restrict__ V, const float* __restrict__ act,
                 const float* __restrict__ prev_logm,
                 const int* __restrict__ prev_L,
                 float* __restrict__ w0_out, float* __restrict__ voiced,
                 float* __restrict__ amps, float* __restrict__ f_logm,
                 int* __restrict__ f_L, int Tn, float pred_decay,
                 float amp_scale) {
    __shared__ float s_logm[MAX_L];
    __shared__ float s_part[THREADS / 32];

    const int c = blockIdx.x;
    const int l = threadIdx.x;
    const bool lane = l < MAX_L;
    const float lidx = (float)(l + 1);
    if (lane) s_logm[l] = prev_logm[(size_t)c * MAX_L + l];
    int p_L = prev_L[c];
    __syncthreads();

    for (int t = 0; t < Tn; ++t) {
        const size_t ct = (size_t)c * Tn + t;
        const int L_t = L[ct];
        const int K_t = K[ct];
        const float a_t = act[ct];
        const float Lf = (float)L_t;
        const float pl = (float)p_L;
        const float Lden = fmaxf(Lf, 1.0f);

        float pvalid = 0.0f, mask = 0.0f;
        if (lane) {
            const float k = (pl > 0.0f ? __fdiv_rn(lidx * pl, Lden) : 1.0f)
                            - 1.0f;
            const int kmax = max(p_L - 1, 0);
            const int k0 = min(max((int)floorf(k), 0), kmax);
            const int k1 = min(k0 + 1, kmax);
            const float frac = fminf(fmaxf(k - (float)k0, 0.0f), 1.0f);
            const float pred_full = (1.0f - frac) * s_logm[k0]
                                    + frac * s_logm[k1];
            mask = (lidx <= Lf) ? 1.0f : 0.0f;
            pvalid = pred_full * mask;
        }
        // masked mean over the block: warp shuffles, then two partials
        float s = pvalid;
        for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
        if ((l & 31) == 0) s_part[l >> 5] = s;
        __syncthreads();                 // also: every read of s_logm done
        const float pmean = __fdiv_rn(s_part[0] + s_part[1], Lden);

        if (lane) {
            const float pred = pred_decay * (pvalid - pmean) * mask;
            const float logm = (T[ct * MAX_L + l] + (p_L > 0 ? pred : 0.0f))
                               * mask;
            const int band = min(l / 3, K_t - 1);
            const float v = V[ct * N_BANDS + band] * mask;
            const float lc = fminf(fmaxf(logm, -4.0f), 14.0f);
            voiced[ct * MAX_L + l] = v * a_t;
            amps[ct * MAX_L + l] = exp2f(lc) * mask * amp_scale * a_t;
            if (a_t > 0.0f) s_logm[l] = logm;
        }
        if (l == 0) w0_out[ct] = w0[ct] * a_t;
        if (a_t > 0.0f) p_L = L_t;
        __syncthreads();                 // carry written before next step
    }
    if (lane) f_logm[(size_t)c * MAX_L + l] = s_logm[l];
    if (l == 0) f_L[c] = p_L;
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
    imbe_pred_kernel<<<C, THREADS, 0, stream>>>(
        T, w0, L, K, V, act, prev_logm, prev_L, w0_out, voiced, amps,
        f_logm, f_L, Tn, pred_decay, amp_scale);
    return (int)cudaGetLastError();
}
