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
// What bounds them on the card: latency.  The recurrence is serial in time
// (13 dependent float ops per step on the loop-carried chain pe -> pe, in
// all four kernels, besides the compares and selects) and parallel only
// over streams, and the mode-0 serving batch has C=512 channels x 2 lanes
// = 1024 streams, a small fraction of the threads the card can hold.  Every
// kernel keeps the carry in registers, gives each stream its own thread
// and each 32 streams their own block (so the blocks spread over the SMs,
// one each).
//
// B2's design moves the memory traffic off the chain.  A block holds 32
// streams and two warps: warp 0 scans, warp 1 moves the data.  Time goes
// in tiles of kTile = 128 steps.  While warp 0 scans tile k from shared
// memory, writing each step's phase into a shared output tile, warp 1
// copies tile k + 1 of the batch-major [S, N] input (its 32 rows x 128
// samples) into the other of two input buffers with cp.async (16-byte
// copies when N is a multiple of 4 and the tensors are 16-byte aligned,
// 4-byte ones otherwise) and stores the phases of tile k - 1 from the
// other of two output buffers with coalesced stores, lane l on the l-th 16
// bytes of a row.  One named barrier of the two warps a tile hands the
// buffers over.  Rows are padded to kStride = 132 floats, so warp 0's
// 16-byte read of each lane's own row's next four samples, and its write
// of four phases, are bank-conflict free across each quarter-warp.  The
// inner loop takes 8 steps a turn, unrolled twice, so the shared-memory
// reads of later steps issue ahead of the chain.  Four tiles take 67,584
// bytes of shared memory (the launch raises the block's limit above 48
// KB).  A tail tile takes N mod 128 steps, a block of fewer than 32 live
// rows masks the rest (their lanes shadow the last live row's parameters
// and scan a row nobody stores), and N = 0 only passes the carry through.
// The scanning warp does not move the data itself: issued in a burst at
// each tile boundary, 32 rows of copies and stores stall its chain.
//
// B8, B9 and B9-expand keep the first port's layout: each thread walks its
// own row of the [S, N] input and output, so each 128-byte line it touches
// serves 32 (B8: 128) consecutive steps from L1, and each warp-wide store
// lands on 32 rows.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics, in the order of pll.py:104-119, and the file is also built
// with -fmad=false, so no multiply-add contracts into an FMA.  The phases
// and the carry then equal the port's plain torch scan bit for bit, which
// the exact time-sharded receiver needs.  The constants (pi, 2pi, 1/2pi,
// 4pi) come from the caller as float32 values so both sides use the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;                 // streams per block
constexpr int kTile = 128;                // time steps per tile
constexpr int kStride = kTile + 4;        // padded row, floats (16-B aligned)
constexpr int kScanSmem = 4 * kWarp * kStride * 4;  // 2 in + 2 out

// One step of pll.py's sign-mode recurrence: the pre-update phase, the
// carry (integ, pe, ang) updated in place.
__device__ __forceinline__ float sign_step(float xt, float& integ, float& pe,
                                           float& ang, float kps, float kis,
                                           float dth, float pi, float two_pi,
                                           float inv_two_pi, float wrap) {
  const float tk = xt < 0.0f ? pi : 0.0f;
  const float ph = __fadd_rn(ang, pe);
  // wrap(tk - phi) to [-pi, pi): the atan2 phase detector
  const float v = __fadd_rn(__fsub_rn(tk, ph), pi);
  float err = __fsub_rn(
      __fsub_rn(v, __fmul_rn(two_pi, floorf(__fmul_rn(v, inv_two_pi)))), pi);
  if (xt == 0.0f) err = 0.0f;  // zero-input guard
  integ = __fadd_rn(integ, __fmul_rn(kis, err));
  float p = __fadd_rn(__fadd_rn(pe, __fmul_rn(kps, err)), integ);
  p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
  pe = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
  const float a = __fadd_rn(ang, dth);
  ang = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
  return ph;  // the pre-update phase: the NCO lags the input by one
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

// The warp copies samples [t0, t0 + len) of rows s0 .. s0 + rows - 1 of x
// into tile (row r at r * kStride), asynchronously.
template <bool kVec>
__device__ __forceinline__ void copy_tile(float* tile,
                                          const float* __restrict__ x,
                                          long long s0, int rows,
                                          long long n, long long t0, int len,
                                          int lane) {
  for (int r = 0; r < rows; ++r) {
    const float* src = x + (s0 + r) * n + t0;
    float* dst = tile + r * kStride;
    if (kVec) {
      for (int c = 4 * lane; c < len; c += 4 * kWarp)
        cp_async16(dst + c, src + c);
    } else {
      for (int c = lane; c < len; c += kWarp) cp_async4(dst + c, src + c);
    }
  }
}

// The warp stores samples [0, len) of tile rows 0 .. rows - 1 to phi,
// coalesced; eight rows (two with 4-byte stores) are read from shared
// memory before any of them is stored.
template <bool kVec>
__device__ __forceinline__ void store_tile(float* __restrict__ phi,
                                           const float* __restrict__ tile,
                                           long long s0, int rows,
                                           long long n, long long t0,
                                           int len, int lane) {
  static_assert(kTile == 4 * kWarp, "one 16-byte chunk of a row per lane");
  if (kVec) {
    const int c = 4 * lane;
    for (int r0 = 0; r0 < rows; r0 += 8) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (r0 + i < rows && c < len)
          v[i] = *reinterpret_cast<const float4*>(tile + (r0 + i) * kStride +
                                                  c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (r0 + i < rows && c < len)
          *reinterpret_cast<float4*>(phi + (s0 + r0 + i) * n + t0 + c) = v[i];
    }
  } else {
    for (int r0 = 0; r0 < rows; r0 += 2) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i / 4, c = lane + kWarp * (i % 4);
        if (r < rows && c < len) v[i] = tile[r * kStride + c];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i / 4, c = lane + kWarp * (i % 4);
        if (r < rows && c < len) phi[(s0 + r) * n + t0 + c] = v[i];
      }
    }
  }
}

// The two warps of a B2 block meet here once a tile (barrier 1; 0 is
// __syncthreads()).
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWarp) : "memory");
}

// B2.  32 streams a block; warp 0 scans, warp 1 copies and stores.  kVec:
// N % 4 == 0 and x, phi 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(2 * kWarp) pll_phase_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ kp,
    const float* __restrict__ ki, const float* __restrict__ dtheta,
    const float* __restrict__ integ0, const float* __restrict__ pe0,
    const float* __restrict__ ang0, float* __restrict__ phi,
    float* __restrict__ integ1, float* __restrict__ pe1,
    float* __restrict__ ang1, long long n_streams, long long n, float pi,
    float two_pi, float inv_two_pi, float wrap) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTileFloats = kWarp * kStride;
  float* in_tiles = smem;                        // [2][kWarp][kStride]
  float* out_tiles = smem + 2 * kTileFloats;     // [2][kWarp][kStride]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long s0 = static_cast<long long>(blockIdx.x) * kWarp;
  const long long left = n_streams - s0;
  const int rows = left < kWarp ? static_cast<int>(left) : kWarp;
  const long long tiles = (n + kTile - 1) / kTile;
  auto tile_len = [n](long long k) {
    const long long rest = n - k * kTile;
    return rest < kTile ? static_cast<int>(rest) : kTile;
  };

  if (warp == 1) {
    // between barriers k - 1 and k: tile k + 1 in, tile k - 1's phases out
    if (tiles > 0) {
      copy_tile<kVec>(in_tiles, x, s0, rows, n, 0, tile_len(0), lane);
      cp_async_commit();
      cp_async_wait<0>();
    }
    pair_sync();
    for (long long k = 0; k < tiles; ++k) {
      if (k + 1 < tiles) {
        copy_tile<kVec>(in_tiles + ((k + 1) & 1) * kTileFloats, x, s0, rows,
                        n, (k + 1) * kTile, tile_len(k + 1), lane);
        cp_async_commit();
      }
      if (k > 0)
        store_tile<kVec>(phi, out_tiles + ((k - 1) & 1) * kTileFloats, s0,
                         rows, n, (k - 1) * kTile, tile_len(k - 1), lane);
      cp_async_wait<0>();
      pair_sync();
    }
    if (tiles > 0)
      store_tile<kVec>(phi, out_tiles + ((tiles - 1) & 1) * kTileFloats, s0,
                       rows, n, (tiles - 1) * kTile, tile_len(tiles - 1),
                       lane);
    return;
  }

  const int r = lane < rows ? lane : rows - 1;   // masked lanes shadow
  const long long s = s0 + r;
  const float kps = kp[s];
  const float kis = ki[s];
  const float dth = dtheta[s];
  float integ = integ0[s];
  float pe = pe0[s];
  float ang = ang0[s];
  pair_sync();                                   // tile 0 is in
  for (long long k = 0; k < tiles; ++k) {
    const int len = tile_len(k);
    const float* xs = in_tiles + (k & 1) * kTileFloats + r * kStride;
    float* os = out_tiles + (k & 1) * kTileFloats + lane * kStride;
    int j = 0;
#pragma unroll 2
    for (; j + 8 <= len; j += 8) {
      const float4 a = *reinterpret_cast<const float4*>(xs + j);
      const float4 b = *reinterpret_cast<const float4*>(xs + j + 4);
      float4 pa, pb;
      pa.x = sign_step(a.x, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pa.y = sign_step(a.y, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pa.z = sign_step(a.z, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pa.w = sign_step(a.w, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pb.x = sign_step(b.x, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pb.y = sign_step(b.y, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pb.z = sign_step(b.z, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      pb.w = sign_step(b.w, integ, pe, ang, kps, kis, dth, pi, two_pi,
                       inv_two_pi, wrap);
      *reinterpret_cast<float4*>(os + j) = pa;
      *reinterpret_cast<float4*>(os + j + 4) = pb;
    }
    for (; j < len; ++j)
      os[j] = sign_step(xs[j], integ, pe, ang, kps, kis, dth, pi, two_pi,
                        inv_two_pi, wrap);
    pair_sync();                                 // tile k scanned, k + 1 in
  }
  if (lane < rows) {
    integ1[s] = integ;
    pe1[s] = pe;
    ang1[s] = ang;
  }
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

// B2.  x, phi: [n_streams, n]; kp, ki, dtheta and the carries:
// [n_streams].  Returns cudaGetLastError() after the launch (0 =
// launched), or the error of raising the block's shared-memory limit.
extern "C" int dy4_pll_phase_scan(
    const float* x, const float* kp, const float* ki, const float* dtheta,
    const float* integ0, const float* pe0, const float* ang0, float* phi,
    float* integ1, float* pe1, float* ang1, long long n_streams,
    long long n, float pi, float two_pi, float inv_two_pi, float wrap,
    void* stream) {
  if (n_streams <= 0) return 0;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(phi) % 16 == 0;
  auto kernel = vec ? pll_phase_scan_kernel<true>
                    : pll_phase_scan_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((n_streams + kWarp - 1) / kWarp);
  kernel<<<blocks, 2 * kWarp, kScanSmem,
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
