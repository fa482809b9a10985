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
// and k come from the caller as float32 values).  By default the caller
// rebuilds the within-span phases from phi0 and i0 with vectorized torch
// ops (pll.py :: _span_expand).
//
// B9-expand pll_span_expand_kernel replaces the Pallas kernel's
// expand=K option (pll_pallas.py:131-143): instead of phi0 and i0 it
// writes the K within-span phases of every span step, op for op
// _span_expand (pll.py:183-197) on the step's own phi0, error and pre-update
// integrator, with the per-sample kp, ki and dtheta (the recurrence keeps
// the span constants, so the entry takes both sets).  Thread s writes K
// consecutive floats of its own row per step, so a warp's stores land on
// 32 rows: the kernel writes K times the bytes B9 does, off the carry
// chain.
//
// B8 pll_phase_scan_coded_kernel replaces the same Pallas kernel in
// mode="coded" (pll_pallas.py :: phase_scan_coded): the exact time-sharded
// receiver's replay of B2's recurrence from int8 sign codes (POS 0, NEG 1,
// ZERO 2, INVALID 3).  The step is B2's line for line; the target comes
// from the code, ZERO zeroes the error, and an INVALID code keeps the
// whole carry (integ, pe, ang) while its pre-update phase is still
// emitted.  The carry after exactly split_at samples is stored as a
// second carry output (the input carry when split_at is 0, the end carry
// when it is n), so the next chunk's replay can resume there.  On valid
// codes its phases and carries equal B2's on the samples the codes came
// from, bit for bit; the exact sharded receiver rests on that.
//
// What bounds it on the card: latency.  The recurrence is serial in time
// (13 dependent float ops per step on the loop-carried chain pe -> pe, in
// all three kernels, besides the compares and selects) and parallel only over
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

// B9-expand: pll_span_scan_kernel's loop, line for line, with the
// expansion in place of the phi0 / i0 stores.
__global__ void pll_span_expand_kernel(
    const float* __restrict__ targets, const float* __restrict__ kp,
    const float* __restrict__ ki, const float* __restrict__ dtheta,
    const float* __restrict__ integ0, const float* __restrict__ pe0,
    const float* __restrict__ ang0, const float* __restrict__ kp1,
    const float* __restrict__ ki1, const float* __restrict__ dtheta1,
    float* __restrict__ phis, float* __restrict__ integ1,
    float* __restrict__ pe1, float* __restrict__ ang1, long long n_streams,
    long long m, int span, float k, float pi, float two_pi,
    float inv_two_pi, float wrap) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const float kps = kp[s];
  const float kis = ki[s];
  const float dth = dtheta[s];
  const float kp1s = kp1[s];
  const float ki1s = ki1[s];
  const float dth1 = dtheta1[s];
  float integ = integ0[s];
  float pe = pe0[s];
  float ang = ang0[s];
  const float* ts = targets + s * m;
  float* out = phis + s * m * span;
  for (long long t = 0; t < m; ++t) {
    const float tk = ts[t];
    const float ph = __fadd_rn(ang, pe);
    const float v = __fadd_rn(__fsub_rn(tk, ph), pi);
    float err = __fsub_rn(
        __fsub_rn(v, __fmul_rn(two_pi, floorf(__fmul_rn(v, inv_two_pi)))),
        pi);
    if (tk != tk) err = 0.0f;  // NaN target: a dead span
    // out_j = phi0 + j*(dtheta + kp*err + I0) + j(j+1)/2 * ki*err, with
    // the per-sample constants and the pre-update integrator
    const float lin =
        __fadd_rn(__fadd_rn(dth1, __fmul_rn(kp1s, err)), integ);
    const float quad = __fmul_rn(ki1s, err);
    float* o = out + t * span;
    for (int j = 0; j < span; ++j) {
      const float jf = static_cast<float>(j);
      const float tri = static_cast<float>(j * (j + 1) / 2);
      o[j] = __fadd_rn(__fadd_rn(ph, __fmul_rn(jf, lin)),
                       __fmul_rn(tri, quad));
    }
    float p = __fadd_rn(__fadd_rn(pe, __fmul_rn(kps, err)),
                        __fmul_rn(k, integ));
    integ = __fadd_rn(integ, __fmul_rn(kis, err));
    p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
    pe = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
    const float a = __fadd_rn(ang, dth);
    ang = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
  }
  integ1[s] = integ;
  pe1[s] = pe;
  ang1[s] = ang;
}

__global__ void pll_phase_scan_coded_kernel(
    const signed char* __restrict__ codes, const float* __restrict__ kp,
    const float* __restrict__ ki, const float* __restrict__ dtheta,
    const float* __restrict__ integ0, const float* __restrict__ pe0,
    const float* __restrict__ ang0, float* __restrict__ phi,
    float* __restrict__ integ_mid, float* __restrict__ pe_mid,
    float* __restrict__ ang_mid, float* __restrict__ integ1,
    float* __restrict__ pe1, float* __restrict__ ang1, long long n_streams,
    long long n, long long split_at, float pi, float two_pi,
    float inv_two_pi, float wrap) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const float kps = kp[s];
  const float kis = ki[s];
  const float dth = dtheta[s];
  float integ = integ0[s];
  float pe = pe0[s];
  float ang = ang0[s];
  const signed char* cs = codes + s * n;
  float* out = phi + s * n;
  for (long long t = 0; t < n; ++t) {
    if (t == split_at) {  // the carry after exactly split_at samples
      integ_mid[s] = integ;
      pe_mid[s] = pe;
      ang_mid[s] = ang;
    }
    const int code = cs[t];
    const float tk = code == 1 ? pi : 0.0f;  // NEG: target pi
    const float ph = __fadd_rn(ang, pe);
    const float v = __fadd_rn(__fsub_rn(tk, ph), pi);
    float err = __fsub_rn(
        __fsub_rn(v, __fmul_rn(two_pi, floorf(__fmul_rn(v, inv_two_pi)))),
        pi);
    if (code == 2) err = 0.0f;  // ZERO: the zero-input guard
    const float i2 = __fadd_rn(integ, __fmul_rn(kis, err));
    float p = __fadd_rn(__fadd_rn(pe, __fmul_rn(kps, err)), i2);
    p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
    const float p2 = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
    const float a = __fadd_rn(ang, dth);
    const float a2 = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
    if (code != 3) {  // INVALID freezes the carry
      integ = i2;
      pe = p2;
      ang = a2;
    }
    out[t] = ph;  // emitted for every code, INVALID included
  }
  if (split_at >= n) {
    integ_mid[s] = integ;
    pe_mid[s] = pe;
    ang_mid[s] = ang;
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

// B9-expand.  targets: [n_streams, m]; phis: [n_streams, m * span]; kp,
// ki, dtheta (the span's effective constants), kp1, ki1, dtheta1 (the
// per-sample ones) and the carries: [n_streams]; k = span as float.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dy4_pll_span_expand(
    const float* targets, const float* kp, const float* ki,
    const float* dtheta, const float* integ0, const float* pe0,
    const float* ang0, const float* kp1, const float* ki1,
    const float* dtheta1, float* phis, float* integ1, float* pe1,
    float* ang1, long long n_streams, long long m, int span, float k,
    float pi, float two_pi, float inv_two_pi, float wrap, void* stream) {
  if (n_streams <= 0) return 0;
  const int threads = 32;
  const unsigned blocks =
      static_cast<unsigned>((n_streams + threads - 1) / threads);
  pll_span_expand_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      targets, kp, ki, dtheta, integ0, pe0, ang0, kp1, ki1, dtheta1, phis,
      integ1, pe1, ang1, n_streams, m, span, k, pi, two_pi, inv_two_pi,
      wrap);
  return static_cast<int>(cudaGetLastError());
}

// B8.  codes (int8), phi: [n_streams, n]; kp, ki, dtheta and the carries
// (input, after split_at samples, at the end): [n_streams];
// 0 <= split_at <= n.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int dy4_pll_phase_scan_coded(
    const signed char* codes, const float* kp, const float* ki,
    const float* dtheta, const float* integ0, const float* pe0,
    const float* ang0, float* phi, float* integ_mid, float* pe_mid,
    float* ang_mid, float* integ1, float* pe1, float* ang1,
    long long n_streams, long long n, long long split_at, float pi,
    float two_pi, float inv_two_pi, float wrap, void* stream) {
  if (n_streams <= 0) return 0;
  const int threads = 32;
  const unsigned blocks =
      static_cast<unsigned>((n_streams + threads - 1) / threads);
  pll_phase_scan_coded_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      codes, kp, ki, dtheta, integ0, pe0, ang0, phi, integ_mid, pe_mid,
      ang_mid, integ1, pe1, ang1, n_streams, n, split_at, pi, two_pi,
      inv_two_pi, wrap);
  return static_cast<int>(cudaGetLastError());
}
