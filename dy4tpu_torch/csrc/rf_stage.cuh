// The RF stage shared by B1 / B1-corr (frontend.cu) and B11-B13
// (frontend_rf.cu): u8 I/Q -> (x-128)/128 -> the K-tap RF LPF decimating
// by D on both legs, over ext = [iq_tail || block], for the decimated
// outputs [g0, m1) of one row; and the differentiator demod both kernels
// run on its outputs.  B14 (fir.cu) takes its tap layout (load_taps) and
// its MACs (mac4) for float rows.
//
//  * The stage runs in passes of `sub` outputs.  A pass's window of the
//    row sits in shared memory in polyphase order (ext sample e0 + v*D + r
//    at [r][v]), filled with consecutive threads on consecutive pairs of
//    complex samples; the next pass's samples are loaded into registers
//    (kPre pairs a thread, a "round") while this pass multiplies.  A window
//    longer than one round (long filters: more than kRound samples) is
//    filled in several rounds, the later ones loaded while the block
//    waits; B1's plan never asks for one.
//  * A source policy (Pairs, Words) hands the fetch two consecutive
//    complex samples as one 32-bit value: Pairs reads the row as 16-bit
//    I/Q pairs, Words as 32-bit words (two pairs), a funnel shift putting
//    an odd sample first; both give 0x8080 (i.e. 0) outside the block.
//  * The MACs are register-blocked: a thread makes kR = 4 consecutive
//    outputs of one leg (B1: mac4) or of both (B11-B13: mac4x2) from a
//    window that slides through registers, 16 bytes a load, each tap
//    broadcast to the 4 (or 8) outputs.  So a warp's float4 window loads
//    hit all 32 banks once, and a tap feeds 4 (8) FMAs.  A phase's taps
//    are padded with zeros to nq, a multiple of 4.
//  * Where a round lies wholly in the block (every pass but a row's first
//    and last) its loads are unchecked, and a window with no tail sample
//    is staged without the tail's test.
//
// Sum order of an output: phase r outer, tap q inner, FMAs from +0, the
// zero taps at the end of each phase row (they leave the sum as it is).
// It does not depend on the pass or the tile an output falls in, so two
// plans, and B1 and B11, give the same bits.  The demod spells each
// operation with its rounding intrinsic, so no multiply-add is contracted
// and both kernels' fm are the same bits for the same I/Q.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace rf {

constexpr int kThreads = 256;   // threads a block
constexpr int kR = 4;           // consecutive outputs a thread makes
constexpr int kPre = 10;        // sample pairs a thread holds for a round
constexpr int kRound = 2 * kPre * kThreads;  // window samples a round
constexpr float kScale = 0.0078125f;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// A window row of n floats padded to 4 mod 32 words, so that the fill's
// stores (consecutive samples across the D rows) meet at most 2 to a bank.
__host__ __device__ inline int window_row(int n) {
  return n + (36 - n % 32) % 32;
}

// What the stage reads of a kernel's geometry.
struct Geometry {
  int n_in;        // complex samples per row = bs / 2
  int decim;
  int s_rf;        // RF taps - 1: RF tail in input samples
  int sub;         // RF outputs a pass
  int nq;          // taps a polyphase row, padded to 4
  int lp;          // window row, floats
};

// The stage's shared-memory buffers: the taps by phase, hs[r][q] =
// h[s - q*D - r] [D, nq]; the window [D, lp] of each leg; the outputs.
struct Bufs {
  float* hs;
  float* win_i;
  float* win_q;
  float* iq_i;
  float* iq_q;
};

// x rounded to bf16 (round to nearest even) and back to float32: an
// operand of dy4tpu's mm_dtype=bf16 (ops/precision.py).  B1's tensor-core
// RF stage (frontend.cu) rounds the taps of its RF tail sums with it.
__device__ __forceinline__ float bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four taps h[0..3] of kF filters (filter f at h + f*hs) against the
// window a || b, 8 consecutive samples: acc[f][k] += h[f][u] * x[u + k].
template <int kF>
__device__ __forceinline__ void step4(const float* h, int hs, float4 a,
                                      float4 b, float (&acc)[kF][kR]) {
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const float4 hv = ld4(h + f * hs);
    const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < kR; ++k)
        acc[f][k] = fmaf(hh[u], x[u + k], acc[f][k]);
  }
}

// acc[f][k] += sum_{a < 4*n4} h[f][a] * w[a + k], k < kR, taps in order;
// reads w[0, 4*n4 + 4).  h, w 16-byte aligned.
template <int kF>
__device__ __forceinline__ void mac4(const float* h, int hs, const float* w,
                                     int n4, float (&acc)[kF][kR]) {
  float4 a = ld4(w);
  int q = 0;
  for (; q + 8 <= 4 * n4; q += 8) {
    const float4 b = ld4(w + q + 4);
    step4<kF>(h + q, hs, a, b, acc);
    a = ld4(w + q + 8);
    step4<kF>(h + q + 4, hs, b, a, acc);
  }
  if (q < 4 * n4) step4<kF>(h + q, hs, a, ld4(w + q + 4), acc);
}

// Four taps h[0..3] against two windows, a || b (leg 0) and c || e (leg
// 1): acc[leg][k] += h[u] * x_leg[u + k]; one tap load feeds 2 x kR FMAs.
__device__ __forceinline__ void step4x2(const float* h, float4 a, float4 b,
                                        float4 c, float4 e,
                                        float (&acc)[2][kR]) {
  const float x[2][8] = {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w},
                         {c.x, c.y, c.z, c.w, e.x, e.y, e.z, e.w}};
  const float4 hv = ld4(h);
  const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int leg = 0; leg < 2; ++leg)
#pragma unroll
      for (int k = 0; k < kR; ++k)
        acc[leg][k] = fmaf(hh[u], x[leg][u + k], acc[leg][k]);
}

// mac4<1> on both legs' windows wi, wq at once, each sum in mac4's order.
__device__ __forceinline__ void mac4x2(const float* h, const float* wi,
                                       const float* wq, int n4,
                                       float (&acc)[2][kR]) {
  float4 a = ld4(wi), c = ld4(wq);
  int q = 0;
  for (; q + 8 <= 4 * n4; q += 8) {
    const float4 b = ld4(wi + q + 4), e = ld4(wq + q + 4);
    step4x2(h + q, a, b, c, e, acc);
    a = ld4(wi + q + 8);
    c = ld4(wq + q + 8);
    step4x2(h + q + 4, b, a, e, c, acc);
  }
  if (q < 4 * n4)
    step4x2(h + q, a, ld4(wi + q + 4), c, ld4(wq + q + 4), acc);
}

// (v - 128) / 128 for a byte v, exact: v/128 - 1 in one FMA.
__device__ inline float norm(unsigned v) {
  return fmaf(static_cast<float>(v), kScale, -1.0f);
}

// The RF taps by phase into hs [decim, nq], zeros past the last tap, by
// the kStride threads of a block.
template <int kStride = kThreads>
__device__ inline void load_taps(float* hs, const Geometry& g,
                                 const float* h, int tid) {
  for (int i = tid; i < g.decim * g.nq; i += kStride) {
    const int a = (i % g.nq) * g.decim + i / g.nq;
    hs[i] = a <= g.s_rf ? h[g.s_rf - a] : 0.0f;
  }
}

// One row as 16-bit I/Q pairs.
struct Pairs {
  const uint16_t* x;

  // complex samples n and n + 1 of the row (sample n in the low half)
  __device__ unsigned inner(int n) const {
    return x[n] | static_cast<unsigned>(x[n + 1]) << 16;
  }
  // the same for any n; lo_in / hi_in: whether each is wanted at all
  __device__ unsigned pair(long long n, bool lo_in, bool hi_in,
                           int n_in) const {
    const unsigned lo = (lo_in && n >= 0 && n < n_in) ? x[n] : 0x8080u;
    const unsigned hi =
        (hi_in && n + 1 >= 0 && n + 1 < n_in) ? x[n + 1] : 0x8080u;
    return lo | hi << 16;
  }
  // byte b of the row (byte 2n + leg is leg `leg` of sample n)
  __device__ unsigned byte(long long b) const {
    return (x[b >> 1] >> (8 * (b & 1))) & 0xFFu;
  }
};

// One row as 32-bit words, each two I/Q pairs (little-endian: bytes 0 and
// 2 are I, 1 and 3 are Q).
struct Words {
  const uint32_t* x;

  __device__ unsigned inner(int n) const {
    const uint32_t w = x[n >> 1];
    return (n & 1) ? __funnelshift_r(w, x[(n >> 1) + 1], 16) : w;
  }
  __device__ unsigned half(long long n) const {
    return (x[n >> 1] >> (16 * (n & 1))) & 0xFFFFu;
  }
  __device__ unsigned pair(long long n, bool lo_in, bool hi_in,
                           int n_in) const {
    if (lo_in && hi_in && n >= 0 && n + 1 < n_in)
      return inner(static_cast<int>(n));
    const unsigned lo = (lo_in && n >= 0 && n < n_in) ? half(n) : 0x8080u;
    const unsigned hi =
        (hi_in && n + 1 >= 0 && n + 1 < n_in) ? half(n + 1) : 0x8080u;
    return lo | hi << 16;
  }
  __device__ unsigned byte(long long b) const {
    return (x[b >> 2] >> (8 * (b & 3))) & 0xFFu;
  }
};

// The complex samples [e0, e0 + n_samp) of ext that lie in the block, into
// registers: thread tid holds samples 2*tid + 2*kThreads*j and the next
// one, packed in pre[j] (0x8080 outside the block).  n_samp <= kRound.
// Where the whole round lies in the block, every load is made, unchecked.
template <class Src>
__device__ inline void fetch(unsigned (&pre)[kPre], const Src& src,
                             const Geometry& g, long long e0, int n_samp,
                             int tid) {
  const long long n0 = e0 - g.s_rf;  // the block sample at window slot 0
  if (n0 >= 0 && n0 + kRound <= g.n_in) {
    const int b = static_cast<int>(n0) + 2 * tid;
#pragma unroll
    for (int j = 0; j < kPre; ++j) pre[j] = src.inner(b + 2 * j * kThreads);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int l = 2 * (tid + j * kThreads);
    pre[j] = src.pair(e0 + l - g.s_rf, l < n_samp, l + 1 < n_samp, g.n_in);
  }
}

// One fetched sample (a 16-bit I/Q pair) into window slot (r, v); a
// sample in the RF tail straight from it.
__device__ inline void stage_one(const Bufs& s, const Geometry& g,
                                 const float* tail, long long e, int r,
                                 int v, unsigned pair) {
  const int slot = r * g.lp + v;
  const bool in_tail = e < g.s_rf;
  s.win_i[slot] = in_tail ? tail[e] : norm(pair & 0xFFu);
  s.win_q[slot] = in_tail ? tail[g.s_rf + e] : norm((pair >> 8) & 0xFFu);
}

// The fetched samples base + l, l < n_samp, of the window from e0 into
// shared memory in polyphase order (window sample w at [w % D][w / D], the
// phase and column stepped, not divided, per j).
__device__ inline void stage_window(const unsigned (&pre)[kPre],
                                    const Bufs& s, const Geometry& g,
                                    const float* tail, long long e0,
                                    int base, int n_samp, int tid) {
  const int d = g.decim;
  const int step = 2 * kThreads;
  const int dv = step / d, dr = step % d;
  int r = (base + 2 * tid) % d, v = (base + 2 * tid) / d;
  if (e0 + base >= g.s_rf) {  // every sample in the block: no tail
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int l = 2 * (tid + j * kThreads);
      const unsigned w = pre[j];
      if (l < n_samp) {
        const int slot = r * g.lp + v;
        s.win_i[slot] = norm(w & 0xFFu);
        s.win_q[slot] = norm((w >> 8) & 0xFFu);
        if (l + 1 < n_samp) {
          const int next = r + 1 == d ? v + 1 : slot + g.lp;
          s.win_i[next] = norm((w >> 16) & 0xFFu);
          s.win_q[next] = norm(w >> 24);
        }
      }
      r += dr;
      v += dv;
      if (r >= d) {
        r -= d;
        ++v;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int l = 2 * (tid + j * kThreads);
    if (l < n_samp) {
      stage_one(s, g, tail, e0 + base + l, r, v, pre[j] & 0xFFFFu);
      if (l + 1 < n_samp)
        stage_one(s, g, tail, e0 + base + l + 1, r + 1 == d ? 0 : r + 1,
                  r + 1 == d ? v + 1 : v, pre[j] >> 16);
    }
    r += dr;
    v += dv;
    if (r >= d) {
      r -= d;
      ++v;
    }
  }
}

// The RF outputs [g0, m1) of a row on both legs into iq_i / iq_q from
// slot l0 on: y[m] = sum_a h[s - a] ext[m*D + a].  `src` is the row,
// `tail` its [2, s_rf] RF tail, the taps already in hs.  kLong: the window
// may take more than one round.  kBoth: a thread makes its kR outputs on
// both legs (mac4x2), else on one (mac4).  Ends with every output visible
// to every thread.
template <bool kLong, bool kBoth, class Src>
__device__ void rf_stage(const Bufs& s, const Geometry& g, int g0, int m1,
                         int l0, const Src& src, const float* tail,
                         int tid) {
  const int d = g.decim;
  const int n_rf = m1 - g0;
  const int passes = (n_rf + g.sub - 1) / g.sub;
  const int n_samp = d * (g.sub + g.nq);
  const int first = kLong && n_samp > kRound ? kRound : n_samp;
  const int chunks = g.sub / kR;
  unsigned pre[kPre];
  fetch(pre, src, g, static_cast<long long>(g0) * d, first, tid);
  for (int p = 0; p < passes; ++p) {
    const long long e0 = static_cast<long long>(g0 + p * g.sub) * d;
    __syncthreads();  // the last pass's window consumed (and taps loaded)
    stage_window(pre, s, g, tail, e0, 0, first, tid);
    if (kLong)
      for (int b = kRound; b < n_samp; b += kRound) {
        const int n = n_samp - b < kRound ? n_samp - b : kRound;
        fetch(pre, src, g, e0 + b, n, tid);
        stage_window(pre, s, g, tail, e0, b, n, tid);
      }
    __syncthreads();
    if (p + 1 < passes)
      fetch(pre, src, g, e0 + static_cast<long long>(g.sub) * d, first,
            tid);
    for (int task = tid; task < (kBoth ? 1 : 2) * chunks;
         task += kThreads) {
      const int leg = kBoth ? 0 : task / chunks;
      const int t0 = (task - leg * chunks) * kR;
      const int o = p * g.sub + t0;
      if constexpr (kBoth) {
        float acc[2][kR] = {};
        for (int r = 0; r < d; ++r)
          mac4x2(s.hs + r * g.nq, s.win_i + r * g.lp + t0,
                 s.win_q + r * g.lp + t0, g.nq / 4, acc);
#pragma unroll
        for (int k = 0; k < kR; ++k)
          if (o + k < n_rf) {
            s.iq_i[l0 + o + k] = acc[0][k];
            s.iq_q[l0 + o + k] = acc[1][k];
          }
      } else {
        const float* w = (leg ? s.win_q : s.win_i) + t0;
        float acc[1][kR] = {};
        for (int r = 0; r < d; ++r)
          mac4<1>(s.hs + r * g.nq, 0, w + r * g.lp, g.nq / 4, acc);
        float* out = (leg ? s.iq_q : s.iq_i) + l0 + o;
#pragma unroll
        for (int k = 0; k < kR; ++k)
          if (o + k < n_rf) out[k] = acc[0][k];
      }
    }
  }
  __syncthreads();
}

// The differentiator demod of I/Q (i, q) after (ip, qp), with the
// zero-power guard: (i*(q - qp) - q*(i - ip)) / (i*i + q*q), each
// operation rounded on its own (demod.fm_demod_diff's order).
__device__ __forceinline__ float fm_demod(float i, float q, float ip,
                                          float qp) {
  const float power = __fadd_rn(__fmul_rn(i, i), __fmul_rn(q, q));
  const float num = __fsub_rn(__fmul_rn(i, __fsub_rn(q, qp)),
                              __fmul_rn(q, __fsub_rn(i, ip)));
  return power == 0.0f ? 0.0f : __fdiv_rn(num, power);
}

}  // namespace rf
