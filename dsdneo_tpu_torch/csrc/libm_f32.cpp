// The C library's float32 cos, sin and atan2 over arrays, for the CPU
// path of the timing recovery (symbols/timing.py).
//
// XLA's CPU backend lowers jnp.cos, jnp.sin and jnp.arctan2 on float32 to
// calls of the C library's cosf, sinf and atan2f, which round differently
// from PyTorch's vectorized CPU versions (about 4% of cos values and 16%
// of atan2 values differ by an ulp or more).  The symbol-rate tone and
// the timing phase feed every decision instant, so the CPU path calls
// the same functions and its positions equal the JAX package's bit for
// bit.  One function per operation and one loop each, so the compiler
// has no sin/cos pair to merge into sincosf.  Compiled for the host by
// the port's loader (kernels.load_host), not by nvcc.

#include <cmath>
#include <cstdint>

extern "C" void dsd_cosf(const float* x, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = cosf(x[i]);
}

extern "C" void dsd_sinf(const float* x, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = sinf(x[i]);
}

extern "C" void dsd_atan2f(const float* y, const float* x, float* out,
                           int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = atan2f(y[i], x[i]);
}
