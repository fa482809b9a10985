// PLL phase recurrences: one tiled, two-role loop for four kernels.
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
// is N/K steps long; the integrator update comes after the phase update
// there, in _make_span_step's order, and the span constants kp_eff, ki_eff,
// dth_eff and k come from the caller as float32 values.  By default the
// caller rebuilds the within-span phases from phi0 and i0 with vectorized
// torch ops (pll.py :: _span_expand).
//
// B9-expand pll_span_expand_kernel replaces the Pallas kernel's expand=K
// option (pll_pallas.py:131-143): instead of phi0 and i0 it writes the K
// within-span phases of every span step, op for op _span_expand
// (pll.py:183-197) on the step's own phi0, error and pre-update
// integrator, with the per-sample kp, ki and dtheta (the recurrence keeps
// the span constants, so the entry takes both sets).
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
// = 1024 streams (the sharded point 256), a small fraction of the threads
// the card can hold.  Every kernel keeps the carry in registers, gives each
// stream its own thread and each 32 streams their own block (so the blocks
// spread over the SMs, one each).
//
// The design (tile_loop) moves the memory traffic off the chain.  A block
// holds 32 streams and two roles: warp 0 scans, the data warps (one; two
// for B9-expand) move the data.  Time goes in tiles of kTile = 128 steps.
// While warp 0 scans tile k from shared memory, writing what each step
// emits into shared output tiles, the data warps copy tile k + 1 of the
// batch-major [S, N] input (32 rows x 128 steps) into the other of two
// input buffers with cp.async and store tile k - 1 from the other of two
// output buffers with coalesced stores.  One named barrier of all the
// block's warps a tile hands the buffers over.  A tail tile takes
// N mod 128 steps, a block of fewer than 32 live rows masks the rest
// (their lanes shadow the last live row's parameters and scan a row
// nobody stores), and N = 0 only passes the carry through.  The scanning
// warp does not move the data itself: issued in a burst at each tile
// boundary, 32 rows of copies and stores stall its chain.
//
// What varies is a step policy (what a step reads and emits: SignStep,
// CodedStep, SpanStep, ExpandStep) and an emit policy (how the data warps
// store the staged tiles: RowsEmit, ExpandEmit):
// - float inputs (B2, B9, B9-expand): rows padded to kStride = 132 floats,
//   16-byte copies when N is a multiple of 4 and the tensors are 16-byte
//   aligned, 4-byte ones otherwise; warp 0 reads 8 steps a turn as two
//   16-byte loads of its own row.
// - int8 codes (B8): a tile row is 128 bytes, padded to kCodeStride = 144,
//   so warp 0's 16-byte read of 16 codes puts the 8 lanes of each
//   quarter-warp on distinct banks; 16-byte cp.async chunks when N is a
//   multiple of 16 and the tensors are 16-byte aligned, else byte loads
//   through registers, 8 rows at a time.  split_at leaves the step loop:
//   warp 0 cuts the one tile that holds it into two runs and stores the
//   mid carry between them, so no step compares t with split_at.
// - output rows (B2, B8: the phase; B9: the phase and the pre-update
//   integrator) are staged at kStride floats a row, written 16 bytes a lane
//   by warp 0 (bank-conflict free across each quarter-warp) and stored by
//   the data warp lane l on the l-th 16 bytes of a row.
// - B9-expand stages three rows (ph, lin, quad) and its expansion leaves
//   the chain: the data warps compute the K phases of each step from them
//   (the same __f*_rn ops in _span_expand's order) and store each row's
//   K * 128 floats 16 bytes a lane, lane l on phases 4(l mod K/4) .. +3 of
//   every (32 / (K/4))-th step when K / 4 divides 32 (K = 8: two lanes a
//   step); element by element otherwise.  32 x 1024 phases a tile at K = 8
//   are split over two data warps, 16 rows each.
// Shared memory: 67,584 bytes (B2), 43,008 (B8), 101,376 (B9), 135,168
// (B9-expand); the launch raises the block's limit above 48 KB.
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

#include "cp_async.cuh"

namespace {

constexpr int kWarp = 32;                 // streams per block
constexpr int kTile = 128;                // time steps per tile
constexpr int kStride = kTile + 4;        // padded float row (16-B aligned)
constexpr int kTileFloats = kWarp * kStride;
constexpr int kCodeStride = kTile + 16;   // padded int8 row, bytes

// Everything a launch takes; each kernel reads the fields it needs.
struct ScanArgs {
  const void* x;                          // [S, n] float or int8
  const float *kp, *ki, *dtheta;          // [S]
  const float *kp1, *ki1, *dtheta1;       // [S] B9-expand's per-sample ones
  const float *integ0, *pe0, *ang0;       // [S] the carry in
  float *out0, *out1;                     // [S, n]; B9-expand [S, n * span]
  float *integ_mid, *pe_mid, *ang_mid;    // [S] B8's carry after split_at
  float *integ1, *pe1, *ang1;             // [S] the carry at the end
  long long n_streams, n, split_at;
  int span;
  float k, pi, two_pi, inv_two_pi, wrap;
};

struct Carry {
  float integ, pe, ang;
};

// wrap(tk - ph) to [-pi, pi): the atan2 phase detector
__device__ __forceinline__ float detector(float tk, float ph,
                                          const ScanArgs& a) {
  const float v = __fadd_rn(__fsub_rn(tk, ph), a.pi);
  return __fsub_rn(
      __fsub_rn(v, __fmul_rn(a.two_pi, floorf(__fmul_rn(v, a.inv_two_pi)))),
      a.pi);
}

// The loop filter and NCO of pll.py's sign step after the detector: the
// carry updated in place.
__device__ __forceinline__ void sign_update(float err, Carry& c, float kps,
                                            float kis, float dth,
                                            float wrap) {
  c.integ = __fadd_rn(c.integ, __fmul_rn(kis, err));
  float p = __fadd_rn(__fadd_rn(c.pe, __fmul_rn(kps, err)), c.integ);
  p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
  c.pe = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
  const float a = __fadd_rn(c.ang, dth);
  c.ang = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
}

// The span step's update after the detector (_make_span_step: the phase
// takes k times the pre-update integrator, then the integrator moves).
__device__ __forceinline__ void span_update(float err, Carry& c, float kps,
                                            float kis, float dth, float k,
                                            float wrap) {
  float p = __fadd_rn(__fadd_rn(c.pe, __fmul_rn(kps, err)),
                      __fmul_rn(k, c.integ));
  c.integ = __fadd_rn(c.integ, __fmul_rn(kis, err));
  p = __fsub_rn(p, p >= wrap ? wrap : 0.0f);
  c.pe = __fadd_rn(p, p < 0.0f ? wrap : 0.0f);
  const float a = __fadd_rn(c.ang, dth);
  c.ang = __fsub_rn(a, a >= wrap ? wrap : 0.0f);
}

// ---- step policies: what one step of warp 0 reads and emits ----
// In: the input element; kInStride: its padded tile row; kTurn: steps a
// turn of the unrolled loop (one or two 16-byte reads); kOuts: staged
// floats a step; load(): a turn's inputs; step(): one step, r[0..kOuts).

struct FloatInput {
  using In = float;
  static constexpr int kInStride = kStride;
  static constexpr int kTurn = 8;
  static constexpr bool kSplit = false;
  __device__ static void load(const float* xs, float (&v)[kTurn]) {
    const float4 p = *reinterpret_cast<const float4*>(xs);
    const float4 q = *reinterpret_cast<const float4*>(xs + 4);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  }
};

// B2: pll.py's sign-mode step; emits the pre-update phase.
struct SignStep : FloatInput {
  static constexpr int kOuts = 1;
  float kps, kis, dth;
  __device__ SignStep(const ScanArgs& a, long long s)
      : kps(a.kp[s]), kis(a.ki[s]), dth(a.dtheta[s]) {}
  __device__ void step(float xt, Carry& c, float* r,
                       const ScanArgs& a) const {
    const float tk = xt < 0.0f ? a.pi : 0.0f;
    const float ph = __fadd_rn(c.ang, c.pe);
    float err = detector(tk, ph, a);
    if (xt == 0.0f) err = 0.0f;  // zero-input guard
    sign_update(err, c, kps, kis, dth, a.wrap);
    r[0] = ph;  // the pre-update phase: the NCO lags the input by one
  }
};

// B8: B2's step from a sign code; INVALID keeps the carry.
struct CodedStep {
  using In = signed char;
  static constexpr int kInStride = kCodeStride;
  static constexpr int kTurn = 16;
  static constexpr bool kSplit = true;
  static constexpr int kOuts = 1;
  float kps, kis, dth;
  __device__ CodedStep(const ScanArgs& a, long long s)
      : kps(a.kp[s]), kis(a.ki[s]), dth(a.dtheta[s]) {}
  // 16 codes from one 16-byte read; a code's byte compares with 1, 2 and
  // 3 as the signed value does
  __device__ static void load(const signed char* xs, int (&v)[kTurn]) {
    const int4 w = *reinterpret_cast<const int4*>(xs);
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < kTurn; ++i)
      v[i] = (words[i / 4] >> (8 * (i % 4))) & 0xff;
  }
  __device__ void step(int code, Carry& c, float* r,
                       const ScanArgs& a) const {
    const float tk = code == 1 ? a.pi : 0.0f;  // NEG: target pi
    const float ph = __fadd_rn(c.ang, c.pe);
    float err = detector(tk, ph, a);
    if (code == 2) err = 0.0f;  // ZERO: the zero-input guard
    Carry u = c;
    sign_update(err, u, kps, kis, dth, a.wrap);
    if (code != 3) c = u;  // INVALID freezes the carry
    r[0] = ph;             // emitted for every code, INVALID included
  }
};

// B9: the span step; emits the pre-update phase and integrator.
struct SpanStep : FloatInput {
  static constexpr int kOuts = 2;
  float kps, kis, dth;
  __device__ SpanStep(const ScanArgs& a, long long s)
      : kps(a.kp[s]), kis(a.ki[s]), dth(a.dtheta[s]) {}
  __device__ void step(float tk, Carry& c, float* r,
                       const ScanArgs& a) const {
    const float ph = __fadd_rn(c.ang, c.pe);
    float err = detector(tk, ph, a);
    if (tk != tk) err = 0.0f;  // NaN target: a dead span
    r[0] = ph;
    r[1] = c.integ;            // the pre-update integrator
    span_update(err, c, kps, kis, dth, a.k, a.wrap);
  }
};

// B9-expand: the span step; emits ph, lin and quad, from which the data
// warps build the span's phases: out_j = phi0 + j*(dtheta + kp*err + I0)
// + j(j+1)/2 * ki*err, with the per-sample constants and the pre-update
// integrator.
struct ExpandStep : FloatInput {
  static constexpr int kOuts = 3;
  float kps, kis, dth, kp1s, ki1s, dth1;
  __device__ ExpandStep(const ScanArgs& a, long long s)
      : kps(a.kp[s]), kis(a.ki[s]), dth(a.dtheta[s]), kp1s(a.kp1[s]),
        ki1s(a.ki1[s]), dth1(a.dtheta1[s]) {}
  __device__ void step(float tk, Carry& c, float* r,
                       const ScanArgs& a) const {
    const float ph = __fadd_rn(c.ang, c.pe);
    float err = detector(tk, ph, a);
    if (tk != tk) err = 0.0f;  // NaN target: a dead span
    r[0] = ph;
    r[1] = __fadd_rn(__fadd_rn(dth1, __fmul_rn(kp1s, err)), c.integ);
    r[2] = __fmul_rn(ki1s, err);
    span_update(err, c, kps, kis, dth, a.k, a.wrap);
  }
};

// ---- the data warps' copies (cp_async.cuh) ----

// The warp copies samples [t0, t0 + len) of rows s0 + [r0, r1) of x into
// tile (row r at r * kStride), asynchronously.
template <bool kVec>
__device__ __forceinline__ void copy_tile(float* tile,
                                          const float* __restrict__ x,
                                          long long s0, int r0, int r1,
                                          long long n, long long t0, int len,
                                          int lane) {
  for (int r = r0; r < r1; ++r) {
    const float* src = x + (s0 + r) * n + t0;
    float* dst = tile + r * kStride;
    if (kVec) {
      for (int c = 4 * lane; c < len; c += 4 * kWarp)
        cpa::copy16(dst + c, src + c);
    } else {
      for (int c = lane; c < len; c += kWarp) cpa::copy4(dst + c, src + c);
    }
  }
}

// The same for int8 codes (row r at r * kCodeStride): 16-byte chunks, 4
// rows a warp-wide copy, when kVec (len a multiple of 16); else byte loads
// of 8 rows through registers, then shared-memory stores.
template <bool kVec>
__device__ __forceinline__ void copy_tile(signed char* tile,
                                          const signed char* __restrict__ x,
                                          long long s0, int r0, int r1,
                                          long long n, long long t0, int len,
                                          int lane) {
  if (kVec) {
    constexpr int kChunks = kTile / 16;
    for (int i = lane; i < (r1 - r0) * kChunks; i += kWarp) {
      const int r = r0 + i / kChunks, c = 16 * (i % kChunks);
      if (c < len)
        cpa::copy16(tile + r * kCodeStride + c, x + (s0 + r) * n + t0 + c);
    }
    return;
  }
  static_assert(kTile == 4 * kWarp, "four bytes of a row per lane");
  for (int rb = r0; rb < r1; rb += 8) {
    signed char v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = rb + i, c = lane + kWarp * q;
        if (r < r1 && c < len) v[i][q] = x[(s0 + r) * n + t0 + c];
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = rb + i, c = lane + kWarp * q;
        if (r < r1 && c < len) tile[r * kCodeStride + c] = v[i][q];
      }
  }
}

// ---- emit policies: how the data warps store a tile's staged rows ----

// The warp stores samples [0, len) of tile rows [r0, r1) to out, coalesced;
// eight rows (two with 4-byte stores) are read from shared memory before
// any of them is stored.
template <bool kVec>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float* __restrict__ tile,
                                           long long s0, int r0, int r1,
                                           long long n, long long t0,
                                           int len, int lane) {
  static_assert(kTile == 4 * kWarp, "one 16-byte chunk of a row per lane");
  if (kVec) {
    const int c = 4 * lane;
    for (int rb = r0; rb < r1; rb += 8) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (rb + i < r1 && c < len)
          v[i] = *reinterpret_cast<const float4*>(tile + (rb + i) * kStride +
                                                  c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (rb + i < r1 && c < len)
          *reinterpret_cast<float4*>(out + (s0 + rb + i) * n + t0 + c) = v[i];
    }
  } else {
    for (int rb = r0; rb < r1; rb += 2) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rb + i / 4, c = lane + kWarp * (i % 4);
        if (r < r1 && c < len) v[i] = tile[r * kStride + c];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rb + i / 4, c = lane + kWarp * (i % 4);
        if (r < r1 && c < len) out[(s0 + r) * n + t0 + c] = v[i];
      }
    }
  }
}

// B2, B8, B9: staged row o goes to out0 (o = 0) or out1 (o = 1), [S, n].
template <int kOuts>
struct RowsEmit {
  float* out[2];
  long long n;
  __device__ explicit RowsEmit(const ScanArgs& a) : out{a.out0, a.out1},
                                                    n(a.n) {}
  template <bool kVec>
  __device__ void store(const float* tiles, long long s0, int r0, int r1,
                        long long t0, int len, int lane) const {
#pragma unroll
    for (int o = 0; o < kOuts; ++o)
      store_tile<kVec>(out[o], tiles + o * kTileFloats, s0, r0, r1, n, t0,
                       len, lane);
  }
};

// B9-expand: the span phases of the staged (ph, lin, quad) rows into
// out0, [S, n * span].
struct ExpandEmit {
  float* phis;
  long long row;  // floats a row: n * span
  int span;
  bool by4;       // 16-byte stores: span / 4 divides 32, phis aligned
  __device__ explicit ExpandEmit(const ScanArgs& a)
      : phis(a.out0), row(a.n * a.span), span(a.span),
        by4(a.span % 4 == 0 && kWarp % (a.span / 4) == 0 &&
            reinterpret_cast<uintptr_t>(a.out0) % 16 == 0) {}
  // phase j of a span: ph + j * lin + j(j+1)/2 * quad, in _span_expand's
  // order; jf = j and tri = j(j+1)/2 as floats
  __device__ static float phase(float ph, float lin, float quad, float jf,
                                float tri) {
    return __fadd_rn(__fadd_rn(ph, __fmul_rn(jf, lin)), __fmul_rn(tri, quad));
  }
  template <bool kVec>
  __device__ void store(const float* tiles, long long s0, int r0, int r1,
                        long long t0, int len, int lane) const {
    const float* ph = tiles;
    const float* lin = tiles + kTileFloats;
    const float* quad = tiles + 2 * kTileFloats;
    if (by4) {
      const int per = span / 4;              // 16-byte stores a step
      const int j0 = 4 * (lane % per);       // this lane's first phase
      const int dt = kWarp / per;            // steps a warp-wide store
      float jf[4], tri[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        jf[q] = static_cast<float>(j0 + q);
        tri[q] = static_cast<float>((j0 + q) * (j0 + q + 1) / 2);
      }
      for (int r = r0; r < r1; ++r) {
        float* dst = phis + (s0 + r) * row + t0 * span + j0;
        const int o = r * kStride;
#pragma unroll 4
        for (int t = lane / per; t < len; t += dt) {
          const float p = ph[o + t], l = lin[o + t], qd = quad[o + t];
          *reinterpret_cast<float4*>(dst + t * span) = make_float4(
              phase(p, l, qd, jf[0], tri[0]), phase(p, l, qd, jf[1], tri[1]),
              phase(p, l, qd, jf[2], tri[2]), phase(p, l, qd, jf[3], tri[3]));
        }
      }
      return;
    }
    for (int r = r0; r < r1; ++r) {
      float* dst = phis + (s0 + r) * row + t0 * span;
      const int o = r * kStride;
      for (int e = lane; e < len * span; e += kWarp) {
        const int t = e / span, j = e - t * span;
        dst[e] = phase(ph[o + t], lin[o + t], quad[o + t],
                       static_cast<float>(j),
                       static_cast<float>(j * (j + 1) / 2));
      }
    }
  }
};

// ---- the loop ----

// All the block's warps meet here once a tile (barrier 1; 0 is
// __syncthreads()).
template <int kData>
__device__ __forceinline__ void tile_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"((1 + kData) * kWarp) : "memory");
}

// Steps [j, end) of a tile: single steps up to a multiple of kTurn, then
// whole turns (inputs read 16 bytes at a time, outputs written 16 bytes at
// a time), then single steps.  Returns end.
template <class Step>
__device__ __forceinline__ int scan_run(const Step& st,
                                        const typename Step::In* xs,
                                        float* os, int j, int end, Carry& c,
                                        const ScanArgs& a) {
  constexpr int kTurn = Step::kTurn;
  constexpr int kOuts = Step::kOuts;
  for (; j < end && j % kTurn != 0; ++j) {
    float r[kOuts];
    st.step(xs[j], c, r, a);
#pragma unroll
    for (int o = 0; o < kOuts; ++o) os[o * kTileFloats + j] = r[o];
  }
#pragma unroll 2
  for (; j + kTurn <= end; j += kTurn) {
    decltype(+xs[0]) v[kTurn];
    Step::load(xs + j, v);
    float r[kOuts][kTurn];
#pragma unroll
    for (int i = 0; i < kTurn; ++i) {
      float ri[kOuts];
      st.step(v[i], c, ri, a);
#pragma unroll
      for (int o = 0; o < kOuts; ++o) r[o][i] = ri[o];
    }
#pragma unroll
    for (int o = 0; o < kOuts; ++o)
#pragma unroll
      for (int q = 0; q < kTurn / 4; ++q)
        *reinterpret_cast<float4*>(os + o * kTileFloats + j + 4 * q) =
            make_float4(r[o][4 * q], r[o][4 * q + 1], r[o][4 * q + 2],
                        r[o][4 * q + 3]);
  }
  for (; j < end; ++j) {
    float r[kOuts];
    st.step(xs[j], c, r, a);
#pragma unroll
    for (int o = 0; o < kOuts; ++o) os[o * kTileFloats + j] = r[o];
  }
  return end;
}

template <class Step>
constexpr int smem_bytes() {
  return 2 * (Step::kOuts * kTileFloats * 4 +
              kWarp * Step::kInStride *
                  static_cast<int>(sizeof(typename Step::In)));
}

// 32 streams a block: warp 0 scans with Step, warps 1 .. kData copy the
// input in and store the staged tiles with Emit, rows split between them.
// kVec: 16-byte copies and stores (the entry checks N and alignment).
template <class Step, class Emit, int kData, bool kVec>
__device__ __forceinline__ void tile_loop(const ScanArgs& a) {
  using In = typename Step::In;
  constexpr int kOutTiles = Step::kOuts * kTileFloats;  // floats a buffer
  constexpr int kInTile = kWarp * Step::kInStride;      // In a buffer
  extern __shared__ __align__(16) unsigned char smem[];
  float* out_tiles = reinterpret_cast<float*>(smem);    // [2][kOuts][32][132]
  In* in_tiles = reinterpret_cast<In*>(smem + 2 * kOutTiles * 4);
  const In* x = static_cast<const In*>(a.x);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long s0 = static_cast<long long>(blockIdx.x) * kWarp;
  const long long left = a.n_streams - s0;
  const int rows = left < kWarp ? static_cast<int>(left) : kWarp;
  const long long n = a.n;
  const long long tiles = (n + kTile - 1) / kTile;
  auto tile_len = [n](long long k) {
    const long long rest = n - k * kTile;
    return rest < kTile ? static_cast<int>(rest) : kTile;
  };

  if (warp > 0) {
    // between barriers k - 1 and k: tile k + 1 in, tile k - 1 out
    constexpr int kPer = kWarp / kData;
    const int r0 = (warp - 1) * kPer;
    const int r1 = rows < r0 + kPer ? rows : r0 + kPer;  // may be empty
    const Emit emit(a);
    if (tiles > 0) {
      copy_tile<kVec>(in_tiles, x, s0, r0, r1, n, 0, tile_len(0), lane);
      cpa::commit();
      cpa::wait<0>();
    }
    tile_sync<kData>();
    for (long long k = 0; k < tiles; ++k) {
      if (k + 1 < tiles) {
        copy_tile<kVec>(in_tiles + ((k + 1) & 1) * kInTile, x, s0, r0, r1, n,
                        (k + 1) * kTile, tile_len(k + 1), lane);
        cpa::commit();
      }
      if (k > 0)
        emit.template store<kVec>(out_tiles + ((k - 1) & 1) * kOutTiles, s0,
                                  r0, r1, (k - 1) * kTile, tile_len(k - 1),
                                  lane);
      cpa::wait<0>();
      tile_sync<kData>();
    }
    if (tiles > 0)
      emit.template store<kVec>(out_tiles + ((tiles - 1) & 1) * kOutTiles,
                                s0, r0, r1, (tiles - 1) * kTile,
                                tile_len(tiles - 1), lane);
    return;
  }

  const int r = lane < rows ? lane : rows - 1;   // masked lanes shadow
  const long long s = s0 + r;
  const Step st(a, s);
  Carry c{a.integ0[s], a.pe0[s], a.ang0[s]};
  const bool live = lane < rows;
  tile_sync<kData>();                            // tile 0 is in
  for (long long k = 0; k < tiles; ++k) {
    const int len = tile_len(k);
    const In* xs = in_tiles + (k & 1) * kInTile + r * Step::kInStride;
    float* os = out_tiles + (k & 1) * kOutTiles + lane * kStride;
    // B8: the tile that holds split_at runs as two runs, the mid carry
    // stored between them
    const long long at = a.split_at - k * kTile;
    if (Step::kSplit && at >= 0 && at < len) {
      const int j = scan_run(st, xs, os, 0, static_cast<int>(at), c, a);
      if (live) {
        a.integ_mid[s] = c.integ;
        a.pe_mid[s] = c.pe;
        a.ang_mid[s] = c.ang;
      }
      scan_run(st, xs, os, j, len, c, a);
    } else {
      scan_run(st, xs, os, 0, len, c, a);
    }
    tile_sync<kData>();                          // tile k scanned, k + 1 in
  }
  if (!live) return;
  if (Step::kSplit && a.split_at >= n) {         // split_at = n
    a.integ_mid[s] = c.integ;
    a.pe_mid[s] = c.pe;
    a.ang_mid[s] = c.ang;
  }
  a.integ1[s] = c.integ;
  a.pe1[s] = c.pe;
  a.ang1[s] = c.ang;
}

template <bool kVec>
__global__ void __launch_bounds__(2 * kWarp)
    pll_phase_scan_kernel(const ScanArgs a) {
  tile_loop<SignStep, RowsEmit<1>, 1, kVec>(a);
}

template <bool kVec>
__global__ void __launch_bounds__(2 * kWarp)
    pll_span_scan_kernel(const ScanArgs a) {
  tile_loop<SpanStep, RowsEmit<2>, 1, kVec>(a);
}

template <bool kVec>
__global__ void __launch_bounds__(3 * kWarp)
    pll_span_expand_kernel(const ScanArgs a) {
  tile_loop<ExpandStep, ExpandEmit, 2, kVec>(a);
}

template <bool kVec>
__global__ void __launch_bounds__(2 * kWarp)
    pll_phase_scan_coded_kernel(const ScanArgs a) {
  tile_loop<CodedStep, RowsEmit<1>, 1, kVec>(a);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One launch of 32 streams a block; returns cudaGetLastError() after it
// (0 = launched), or the error of raising the block's shared-memory limit.
int launch(void (*kernel)(ScanArgs), int smem, int threads,
           const ScanArgs& a, void* stream) {
  if (a.n_streams <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((a.n_streams + kWarp - 1) / kWarp);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ScanArgs scan_args(const void* x, const float* kp, const float* ki,
                   const float* dtheta, const float* integ0,
                   const float* pe0, const float* ang0, float* integ1,
                   float* pe1, float* ang1, long long n_streams, long long n,
                   float pi, float two_pi, float inv_two_pi, float wrap) {
  ScanArgs a{};
  a.x = x;
  a.kp = kp;
  a.ki = ki;
  a.dtheta = dtheta;
  a.integ0 = integ0;
  a.pe0 = pe0;
  a.ang0 = ang0;
  a.integ1 = integ1;
  a.pe1 = pe1;
  a.ang1 = ang1;
  a.n_streams = n_streams;
  a.n = n;
  a.split_at = -1;
  a.pi = pi;
  a.two_pi = two_pi;
  a.inv_two_pi = inv_two_pi;
  a.wrap = wrap;
  return a;
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
  ScanArgs a = scan_args(x, kp, ki, dtheta, integ0, pe0, ang0, integ1, pe1,
                         ang1, n_streams, n, pi, two_pi, inv_two_pi, wrap);
  a.out0 = phi;
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(phi);
  return launch(vec ? pll_phase_scan_kernel<true>
                    : pll_phase_scan_kernel<false>,
                smem_bytes<SignStep>(), 2 * kWarp, a, stream);
}

// B9.  targets, phi0, i0: [n_streams, m]; kp, ki, dtheta (the span's
// effective constants) and the carries: [n_streams]; k = span as float.
// Returns cudaGetLastError() after the launch (0 = launched), or the
// error of raising the block's shared-memory limit.
extern "C" int dy4_pll_span_scan(
    const float* targets, const float* kp, const float* ki,
    const float* dtheta, const float* integ0, const float* pe0,
    const float* ang0, float* phi0, float* i0, float* integ1, float* pe1,
    float* ang1, long long n_streams, long long m, float k, float pi,
    float two_pi, float inv_two_pi, float wrap, void* stream) {
  ScanArgs a = scan_args(targets, kp, ki, dtheta, integ0, pe0, ang0, integ1,
                         pe1, ang1, n_streams, m, pi, two_pi, inv_two_pi,
                         wrap);
  a.out0 = phi0;
  a.out1 = i0;
  a.k = k;
  const bool vec = m % 4 == 0 && aligned16(targets) && aligned16(phi0) &&
                   aligned16(i0);
  return launch(vec ? pll_span_scan_kernel<true>
                    : pll_span_scan_kernel<false>,
                smem_bytes<SpanStep>(), 2 * kWarp, a, stream);
}

// B9-expand.  targets: [n_streams, m]; phis: [n_streams, m * span]; kp,
// ki, dtheta (the span's effective constants), kp1, ki1, dtheta1 (the
// per-sample ones) and the carries: [n_streams]; k = span as float.
// Returns cudaGetLastError() after the launch (0 = launched), or the
// error of raising the block's shared-memory limit.
extern "C" int dy4_pll_span_expand(
    const float* targets, const float* kp, const float* ki,
    const float* dtheta, const float* integ0, const float* pe0,
    const float* ang0, const float* kp1, const float* ki1,
    const float* dtheta1, float* phis, float* integ1, float* pe1,
    float* ang1, long long n_streams, long long m, int span, float k,
    float pi, float two_pi, float inv_two_pi, float wrap, void* stream) {
  ScanArgs a = scan_args(targets, kp, ki, dtheta, integ0, pe0, ang0, integ1,
                         pe1, ang1, n_streams, m, pi, two_pi, inv_two_pi,
                         wrap);
  a.kp1 = kp1;
  a.ki1 = ki1;
  a.dtheta1 = dtheta1;
  a.out0 = phis;
  a.span = span;
  a.k = k;
  const bool vec = m % 4 == 0 && aligned16(targets);
  return launch(vec ? pll_span_expand_kernel<true>
                    : pll_span_expand_kernel<false>,
                smem_bytes<ExpandStep>(), 3 * kWarp, a, stream);
}

// B8.  codes (int8), phi: [n_streams, n]; kp, ki, dtheta and the carries
// (input, after split_at samples, at the end): [n_streams];
// 0 <= split_at <= n.  Returns cudaGetLastError() after the launch
// (0 = launched), or the error of raising the block's shared-memory limit.
extern "C" int dy4_pll_phase_scan_coded(
    const signed char* codes, const float* kp, const float* ki,
    const float* dtheta, const float* integ0, const float* pe0,
    const float* ang0, float* phi, float* integ_mid, float* pe_mid,
    float* ang_mid, float* integ1, float* pe1, float* ang1,
    long long n_streams, long long n, long long split_at, float pi,
    float two_pi, float inv_two_pi, float wrap, void* stream) {
  ScanArgs a = scan_args(codes, kp, ki, dtheta, integ0, pe0, ang0, integ1,
                         pe1, ang1, n_streams, n, pi, two_pi, inv_two_pi,
                         wrap);
  a.out0 = phi;
  a.integ_mid = integ_mid;
  a.pe_mid = pe_mid;
  a.ang_mid = ang_mid;
  a.split_at = split_at;
  const bool vec = n % 16 == 0 && aligned16(codes) && aligned16(phi);
  return launch(vec ? pll_phase_scan_coded_kernel<true>
                    : pll_phase_scan_coded_kernel<false>,
                smem_bytes<CodedStep>(), 2 * kWarp, a, stream);
}
