// PLL phase recurrences: one thread per stream.
//
// B2 pll_phase_scan_kernel replaces dy4tpu/ops/pll_pallas.py :: phase_scan
// (mode="sign"), the Pallas kernel that runs dy4tpu/ops/pll.py ::
// _make_step over a time-major [N, 8, 128] VMEM slab: one step per IF
// sample.
//
// B9 pll_span_scan_kernel replaces the same Pallas kernel in
// mode="target" with emit_integ=True, which runs pll.py :: _make_span_step:
// the span PLL's one loop update per span of K samples, driven by the span
// detector targets (NaN marks a dead span, whose error is 0), emitting the
// pre-update phase and the pre-update integrator of every span.  Its chain
// is N/K steps long; the same design and numerics as B2 apply to it (the
// integrator update comes after the phase update there, in
// _make_span_step's order, and the span constants kp_eff, ki_eff, dth_eff
// and k come from the caller as float32 values).  The within-span
// expansion (the Pallas kernel's expand=K option) is not on the path: the
// caller rebuilds those phases with vectorized torch ops.
//
// What bounds it on the card: latency.  The recurrence is serial in time
// (13 dependent float ops per step on the loop-carried chain pe -> pe, in
// both kernels, besides the compares and selects) and parallel only over
// streams, and the mode-0 serving batch has C=512 channels x 2 lanes =
// 1024 streams, a small fraction of the threads the card can hold.
// The design keeps the carry in registers, gives each stream its own
// thread and each warp its own block (so the 32 warps spread over 32
// SMs), and reads and writes the batch-major [S, N] rows directly: every
// thread walks its own row, so each 128-byte line it touches serves 32
// consecutive steps from L1.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics, in the order of pll.py:104-119, and the file is also built
// with -fmad=false, so no multiply-add contracts into an FMA.  The phases
// and the carry then equal the port's plain torch scan bit for bit, which
// the exact time-sharded receiver needs.  The constants (pi, 2pi, 1/2pi,
// 4pi) come from the caller as float32 values so both sides use the
// same bits.

#include <cuda_runtime.h>

namespace {

__global__ void pll_phase_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ kp,
    const float* __restrict__ ki, const float* __restrict__ dtheta,
    const float* __restrict__ integ0, const float* __restrict__ pe0,
    const float* __restrict__ ang0, float* __restrict__ phi,
    float* __restrict__ integ1, float* __restrict__ pe1,
    float* __restrict__ ang1, long long n_streams, long long n, float pi,
    float two_pi, float inv_two_pi, float wrap) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const float kps = kp[s];
  const float kis = ki[s];
  const float dth = dtheta[s];
  float integ = integ0[s];
  float pe = pe0[s];
  float ang = ang0[s];
  const float* xs = x + s * n;
  float* out = phi + s * n;
  for (long long t = 0; t < n; ++t) {
    const float xt = xs[t];
    const float tk = xt < 0.0f ? pi : 0.0f;
    const float ph = __fadd_rn(ang, pe);
    // wrap(tk - phi) to [-pi, pi): the atan2 phase detector
    const float v = __fadd_rn(__fsub_rn(tk, ph), pi);
    float err = __fsub_rn(
        __fsub_rn(v, __fmul_rn(two_pi, floorf(__fmul_rn(v, inv_two_pi)))),
        pi);
    if (xt == 0.0f) err = 0.0f;  // zero-input guard
    integ = __fadd_rn(integ, __fmul_rn(kis, err));
    float p = __fadd_rn(__fadd_rn(pe, __fmul_rn(kps, err)), integ);
    p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
    pe = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
    const float a = __fadd_rn(ang, dth);
    ang = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
    out[t] = ph;  // the pre-update phase: the NCO lags the input by one
  }
  integ1[s] = integ;
  pe1[s] = pe;
  ang1[s] = ang;
}

__global__ void pll_span_scan_kernel(
    const float* __restrict__ targets, const float* __restrict__ kp,
    const float* __restrict__ ki, const float* __restrict__ dtheta,
    const float* __restrict__ integ0, const float* __restrict__ pe0,
    const float* __restrict__ ang0, float* __restrict__ phi0,
    float* __restrict__ i0, float* __restrict__ integ1,
    float* __restrict__ pe1, float* __restrict__ ang1, long long n_streams,
    long long m, float k, float pi, float two_pi, float inv_two_pi,
    float wrap) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const float kps = kp[s];
  const float kis = ki[s];
  const float dth = dtheta[s];
  float integ = integ0[s];
  float pe = pe0[s];
  float ang = ang0[s];
  const float* ts = targets + s * m;
  float* out = phi0 + s * m;
  float* iout = i0 + s * m;
  for (long long t = 0; t < m; ++t) {
    const float tk = ts[t];
    const float ph = __fadd_rn(ang, pe);
    const float v = __fadd_rn(__fsub_rn(tk, ph), pi);
    float err = __fsub_rn(
        __fsub_rn(v, __fmul_rn(two_pi, floorf(__fmul_rn(v, inv_two_pi)))),
        pi);
    if (tk != tk) err = 0.0f;  // NaN target: a dead span
    iout[t] = integ;           // the pre-update integrator
    float p = __fadd_rn(__fadd_rn(pe, __fmul_rn(kps, err)),
                        __fmul_rn(k, integ));
    integ = __fadd_rn(integ, __fmul_rn(kis, err));
    p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
    pe = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
    const float a = __fadd_rn(ang, dth);
    ang = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
    out[t] = ph;               // the pre-update phase
  }
  integ1[s] = integ;
  pe1[s] = pe;
  ang1[s] = ang;
}

}  // namespace

// x, phi: [n_streams, n]; kp, ki, dtheta and the carries: [n_streams].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dy4_pll_phase_scan(
    const float* x, const float* kp, const float* ki, const float* dtheta,
    const float* integ0, const float* pe0, const float* ang0, float* phi,
    float* integ1, float* pe1, float* ang1, long long n_streams,
    long long n, float pi, float two_pi, float inv_two_pi, float wrap,
    void* stream) {
  if (n_streams <= 0) return 0;
  const int threads = 32;
  const unsigned blocks =
      static_cast<unsigned>((n_streams + threads - 1) / threads);
  pll_phase_scan_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, kp, ki, dtheta, integ0, pe0, ang0, phi, integ1, pe1, ang1,
      n_streams, n, pi, two_pi, inv_two_pi, wrap);
  return static_cast<int>(cudaGetLastError());
}

// B9.  targets, phi0, i0: [n_streams, m]; kp, ki, dtheta (the span's
// effective constants) and the carries: [n_streams]; k = span as float.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dy4_pll_span_scan(
    const float* targets, const float* kp, const float* ki,
    const float* dtheta, const float* integ0, const float* pe0,
    const float* ang0, float* phi0, float* i0, float* integ1, float* pe1,
    float* ang1, long long n_streams, long long m, float k, float pi,
    float two_pi, float inv_two_pi, float wrap, void* stream) {
  if (n_streams <= 0) return 0;
  const int threads = 32;
  const unsigned blocks =
      static_cast<unsigned>((n_streams + threads - 1) / threads);
  pll_span_scan_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      targets, kp, ki, dtheta, integ0, pe0, ang0, phi0, i0, integ1, pe1,
      ang1, n_streams, m, k, pi, two_pi, inv_two_pi, wrap);
  return static_cast<int>(cudaGetLastError());
}
