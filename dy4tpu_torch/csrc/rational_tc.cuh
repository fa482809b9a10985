// The polyphase tile resampler on the tensor cores: B4 (rds_backend.cu)
// and B5 / B3 (audio_rational.cu) at precision "default" / "high",
// dy4tpu's mm_dtype=bf16 dots (resample_pallas.py _audio_kernel and
// _rds_kernel, backend_pallas.py _kernel) as bf16 mma.sync products with
// float32 sums (mma_bf16.cuh).  rational.cuh's float32 walk stays the
// "highest" path; this design shares its Plan and its items.
//
// One matrix for a phase cycle.  Output m = c*span + p of a row (cycle c,
// position p; rational.cuh's note) reads x_ext[c*step + j] for b_p <= j
// <= b_p + S, b_p = (p*step)//span, with tap h[r_p + (b_p + S - j)*U],
// r_p = (p*D) % U.  Each cycle steps exactly `step` inputs, so one banded
// matrix H[j][p] serves every cycle of every row and leg (a stream):
//   Y[(stream, c), p] = sum_j X[stream, c*step + j] * H[j][p],
// a GEMM with M = streams x cycles, N = the span's positions, K = the
// cycle's window.  At U = 1 a cycle is 8 consecutive outputs (step = 8D),
// every position taking all of h: mma_bf16.cuh's decimating Toeplitz
// product.
//
// What bounds it on the card: bytes, the three float32 input streams (the
// products are under a GFLOP a block, microseconds on the tensor cores);
// in practice the latency of the copy warps' loads and of the compute
// warps' chains (PERF.md, PR 23).  The design, on rational.cuh's
// persistent blocks (one an SM) and items:
//  * The positions split into groups of 8 columns, the n8 of m16n8k16.
//    Group g reads x_ext[c*step + j0_g + k], k < 16*ks: j0_g is b of its
//    first position rounded down to S mod 8, ks the k-steps of the widest
//    group (160 / 144 / 160 / 176 samples at 19/120, 171/640, 147/800 and
//    147/1280; 144 / 176 at U = 1 with D = 5 / 8).
//  * The copy warps mix each input sample in float32 (the plain versions'
//    products) and store it rounded to bf16, one window a stream (the A
//    operand): window slot u (x_ext[c_lo*step + u]) at v = u + lead, after
//    lead = (-S) mod 8 zeros, so a group's A row starts at v = c*step +
//    j0_g + lead, a multiple of 8 (16-byte aligned, as ldmatrix wants),
//    and the inputs' 16-byte quads land on 8-byte aligned bf16 quads.
//    Where step is 8 mod 16 (19/120; D = 5 at U = 1) the 8 rows of an
//    ldmatrix, `step` apart, fall on distinct banks; where step is a
//    multiple of 16 they would share banks, so the window is skewed: v
//    sits at v + pad * (v / step), pad = 8, the cycle rows step + 8 apart.
//    An ldmatrix row is 8 bf16 from a multiple of 8, which never straddles
//    a skew, so nothing is stored twice.  In a row's last tile the copy
//    warps also write the new input tails, the last S float32 mixes.
//  * The copy warps fill a ring of `bufs` windows (3 where they fit), item
//    k into window k mod bufs, and run up to bufs - 1 items ahead of the
//    compute warps; named barriers hand each window over, full and empty
//    again (run).  A lockstep of one barrier an item cost 10-18%.
//  * The B fragments of every (group, k-step) are built once a block in
//    shared memory while the copy warps load the first items: h read in
//    natural order, each tap rounded to bf16 (round to nearest even, the
//    bits of precision.taps) and scattered to its one place (its 8 places
//    at U = 1).  An M tile is 8 cycles of one row, leg 0 in its rows 0-7
//    and leg 1 in rows 8-15, so a lane's accumulators hold both legs of
//    its outputs.  A compute warp takes Io::kChains (group, M tile) pairs
//    at once, independent chains: one ldmatrix.x4 and one 8-byte fragment
//    read a pair and k-step, all issued before the k-step's MMAs.  B3 / B5
//    stage the sums in shared memory and store mono, left = mono + stereo
//    and right = mono - stereo 16 bytes a store; B4 rounds its stream to
//    bf16 straight into its RRC input (and stores the row's last S2
//    outputs, float32, to the new RRC tail).
//  * B4's RRC: the resampled stream (the carried RRC tail, loaded before
//    the resampler's MMAs, or the halo before the tile) in bf16, as
//    dy4tpu's _rds_kernel casts ext2_s, then mma_bf16.cuh's decim-1
//    Toeplitz product (7 k-steps), each MMA row 8 outputs from a multiple
//    of 8 of the row's outputs (a halo of at least K2 - 1 + 7), stored
//    straight from the accumulators, Io::kChains units a warp.
//  * Each kernel's block is its Io's: Io::kThreads threads, half of them
//    compute, the copy threads keeping Io::kVec 16-byte loads of each
//    input in flight.  B4, whose RRC doubles the compute, takes 1024
//    threads (64 registers each), B3 / B5 512 (128).
//
// Numerics: every output's sum is its group's ks k-steps in order from +0,
// over samples fixed by its cycle and group alone, so an output (a halo
// output too) has the same bits under every plan; reads past a group's
// band meet zero taps.  The products are exact, the sums float32 in the
// tensor cores' order.  The carried tails stay the float32 samples: the
// input tails the unrounded mixes, B4's RRC tail the unrounded stream.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"
#include "rational.cuh"

namespace rational_tc {

using rational::Item;
using rational::Plan;

constexpr int kCopyUnroll = 8;  // 4-byte loads of an input in flight
constexpr int kTapUnroll = 4;   // 16-byte loads of h in flight

// b_p: the newest input of position `pos`, less S, from its cycle's start.
__host__ __device__ inline int newest(const Plan& p, int pos) {
  return static_cast<int>(static_cast<long long>(pos) * p.step / p.span);
}

// j0 of group g: b of its first position rounded down to S mod 8.
__host__ __device__ inline int group_start(const Plan& p, int g) {
  const int b = newest(p, 8 * g);
  return b - ((b - p.s) % 8 + 8) % 8;
}

// Shared memory, in bytes (resample_cuda._tc_layout), each region a
// multiple of 16: the B fragments [col_groups][ks][32] and B4's RRC
// fragments [ks2][32] (uint2 a lane), a table of ints (3 x 256: each
// phase's place in the fragments, each group's first window sample), a
// ring of `bufs` windows of 2 * rows streams x slen bf16, and B4's RRC
// input (2 * rows x rlen bf16) or B3 / B5's staged outputs (2 * rows x
// ystride floats).
constexpr int kTable = 3 * 256;
constexpr int kMaxBufs = 3;     // ring windows (resample_cuda.TC_MAX_BUFS)

struct Layout {
  int frag, frr, table, win, rb, total;
};

__host__ __device__ inline Layout layout(const Plan& p) {
  Layout l;
  l.frag = 0;
  l.frr = l.frag + 256 * p.col_groups * p.ks;
  l.table = l.frr + 256 * p.ks2;
  l.win = l.table + 4 * kTable;
  l.rb = l.win + 4 * p.bufs * p.rows * p.slen;
  l.total = l.rb + 4 * p.rows * p.rlen + 8 * p.rows * p.ystride;
  return l;
}

// v / step for 0 <= v < 2^32 / step, by step_inv = ceil(2^32 / step).
__host__ __device__ __forceinline__ int div_step(const Plan& p, int v) {
#ifdef __CUDA_ARCH__
  return static_cast<int>(__umulhi(static_cast<unsigned>(v), p.step_inv));
#else
  return static_cast<int>((static_cast<unsigned long long>(v) * p.step_inv) >>
                          32);
#endif
}

// Where window position v (slot v - lead) sits in a stream's window: v,
// skewed by pad every step (the note).
__host__ __device__ __forceinline__ int place(const Plan& p, int v) {
  return v + p.pad * div_step(p, v);
}

// A plan the kernel cannot run is refused before the launch.
inline bool plan_ok(const Plan& p) {
  if (!(p.up >= 1 && p.up <= 256 && p.down >= 1 &&
        p.span == (p.up > 1 ? p.up : tc::kN) && p.step > 0 &&
        p.step % 8 == 0 &&
        p.col_groups == (p.span + tc::kN - 1) / tc::kN &&
        p.lead == ((-p.s) % 8 + 8) % 8 && p.ks >= 1 && p.reach % 8 == 0 &&
        p.pad == (p.step % 16 ? 0 : 8) &&
        p.step_inv == static_cast<unsigned>(((1ULL << 32) + p.step - 1) /
                                            p.step)))
    return false;
  for (int g = 0; g < p.col_groups; ++g) {
    const int last = 8 * g + 7 < p.span ? 8 * g + 7 : p.span - 1;
    const int j0 = group_start(p, g);
    if (newest(p, last) + p.s + 1 - j0 > tc::kK * p.ks ||
        j0 + p.lead + tc::kK * p.ks > p.reach)
      return false;
  }
  const int cycles_row = p.n_in / p.step;
  const int ncyc = p.cycles + p.halo_cycles;
  const int tile = p.cycles * p.span;
  const int written = p.lead + p.s + ncyc * p.step;
  const int read = (ncyc - 1) * p.step + p.reach;
  const int vend = written > read ? written : read;
  const bool rows_ok = static_cast<long long>(vend) * p.step < (1LL << 32) &&
                       p.slen >= place(p, vend - 1) + 1;
  const bool rrc_ok =
      p.k2 ? p.ks2 == tc::ksteps(1, p.k2) && p.rlen % 8 == 0 &&
                 p.ystride == 0 &&
                 p.rlen >= (tile + 7 + tc::kUnit - 1) / tc::kUnit *
                                   tc::kUnit - 8 + tc::kK * p.ks2 &&
                 (p.n_tiles == 1 ||
                  (p.halo_cycles * p.span >= p.k2 - 1 + 7 &&
                   p.cycles >= p.halo_cycles))
           : p.ks2 == 0 && p.rlen == 0 && p.halo_cycles == 0 &&
                 p.ystride % 4 == 0 && p.ystride >= tile;
  return rows_ok && rrc_ok && p.slen % 8 == 0 && p.n_in % p.step == 0 &&
         p.rows >= 1 && p.cycles >= 1 && p.cycles <= cycles_row &&
         p.n_tiles == (cycles_row + p.cycles - 1) / p.cycles &&
         p.items == (p.c + p.rows - 1) / p.rows * p.n_tiles &&
         p.compute_threads >= 32 && p.compute_threads % 32 == 0 &&
         p.threads > p.compute_threads && p.threads % 32 == 0 &&
         p.threads <= 1024 && p.bufs >= 2 && p.bufs <= kMaxBufs &&
         p.ctas >= 1 &&
         p.ctas <= p.items && rational_tc::layout(p).total == p.smem;
}

// Copy thread `lane` of `n`: item `it`'s windows into `win` (a buffer), the
// two legs of row r at streams 2r and 2r + 1, each mixed sample rounded
// to bf16: window slot u is x_ext[c_lo*step + u] at place(u + lead), the
// slots before u0 from the carried tail, the rest from the row, 16 bytes a
// load where the row is 16-byte aligned; then zeros where the last cycle
// row reads past the window.  In a row's last tile the new input tails,
// the row's last S mixes in float32, go to device memory as they pass
// (Io::put_tail).
template <class Io>
__device__ __forceinline__ void load_window(const Io& io, const Plan& p,
                                            const Item& it, uint16_t* win,
                                            int lane, int n) {
  const int nci = it.c_hi - it.c_lo;
  const int len = p.s + nci * p.step;
  const long long wx0 = static_cast<long long>(it.c_lo) * p.step;
  const int u0 = wx0 < p.s ? p.s - static_cast<int>(wx0) : 0;
  // the row's inputs [g0, g1) are slots g + s - wx0; from t0 on its tail
  const int g0 = static_cast<int>(wx0 + u0 - p.s);
  const int g1 = static_cast<int>(wx0 + len - p.s);
  const int shift = p.s - static_cast<int>(wx0);
  const int t0 = g1 == p.n_in ? p.n_in - p.s : p.n_in;
  const int vshift = shift + p.lead;   // input g sits at v = g + vshift
  for (int r = 0; r < it.nrows; ++r) {
    const long long row = it.row0 + r;
    uint16_t* w0 = win + 2 * r * p.slen;
    uint16_t* w1 = w0 + p.slen;
    auto put_v = [&](int v, float2 x) {
      const int at = rational_tc::place(p, v);
      w0[at] = static_cast<uint16_t>(tc::bf16_bits(x.x));
      w1[at] = static_cast<uint16_t>(tc::bf16_bits(x.y));
    };
    auto put = [&](int g, float2 x) {
      put_v(g + vshift, x);
      if (g >= t0) io.put_tail(row, g - t0, p.s, x);
    };
    for (int u = lane; u < u0; u += n)
      put_v(u + p.lead, io.tail(row, static_cast<int>(wx0) + u, p.s));
    const long long xr = row * p.n_in;
    int g = g0;
    if (io.aligned(xr)) {
      // quads of inputs from a multiple of 4: slot + lead a multiple of 4
      const int q0 = (g0 + 3) / 4;
      const int q1 = g1 / 4;
      for (int h = g0 + lane; h < 4 * q0 && h < g1; h += n) {
        float a, b, c;
        io.fetch(xr + h, a, b, c);
        put(h, io.mix(a, b, c));
      }
      constexpr int kVecUnroll = Io::kVec;
      for (int q = q0 + lane; q < q1; q += n * kVecUnroll) {
        float4 a[kVecUnroll], b[kVecUnroll], c[kVecUnroll];
#pragma unroll
        for (int i = 0; i < kVecUnroll; ++i)
          if (q + i * n < q1) io.fetch4(xr + 4 * (q + i * n), a[i], b[i], c[i]);
#pragma unroll
        for (int i = 0; i < kVecUnroll; ++i) {
          if (q + i * n < q1) {
            const int gq = 4 * (q + i * n);
            const float2 m[4] = {io.mix(a[i].x, b[i].x, c[i].x),
                                 io.mix(a[i].y, b[i].y, c[i].y),
                                 io.mix(a[i].z, b[i].z, c[i].z),
                                 io.mix(a[i].w, b[i].w, c[i].w)};
            const uint2 l0 = make_uint2(tc::pack(m[0].x, m[1].x),
                                        tc::pack(m[2].x, m[3].x));
            const uint2 l1 = make_uint2(tc::pack(m[0].y, m[1].y),
                                        tc::pack(m[2].y, m[3].y));
            const int at = rational_tc::place(p, gq + vshift);
            *reinterpret_cast<uint2*>(w0 + at) = l0;
            *reinterpret_cast<uint2*>(w1 + at) = l1;
            if (gq + 3 >= t0) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (gq + e >= t0) io.put_tail(row, gq + e - t0, p.s, m[e]);
            }
          }
        }
      }
      g = 4 * q1 > g0 ? 4 * q1 : g0;
    }
    for (g += lane; g < g1; g += n * kCopyUnroll) {
      float a[kCopyUnroll], b[kCopyUnroll], c[kCopyUnroll];
#pragma unroll
      for (int i = 0; i < kCopyUnroll; ++i)
        if (g + i * n < g1) io.fetch(xr + g + i * n, a[i], b[i], c[i]);
#pragma unroll
      for (int i = 0; i < kCopyUnroll; ++i)
        if (g + i * n < g1) put(g + i * n, io.mix(a[i], b[i], c[i]));
    }
    // zeros past the window where the last cycle row reads
    for (int v = p.lead + len + lane; v < (nci - 1) * p.step + p.reach;
         v += n)
      w0[rational_tc::place(p, v)] = w1[rational_tc::place(p, v)] = 0;
  }
}

// Compute thread `ctid`: the B fragments of every (group, k-step) into
// `frag` and of B4's RRC into `frr`, each tap rounded to bf16.  H[j][p] of
// group g's k-step kk, j = j0_g + 16 kk + k, is tap r_p + (b_p + S - j)*U:
// each tap of h, read in natural order, scattered to its places.  First
// the table: each phase's place (at U > 1 phase r's position p = r *
// D^-1 mod U, at U = 1 each of the 8 positions, all phase 0): table[i] the
// bf16 of its column's first fragment, table[256 + i] its k0 = b_p + S -
// j0_g (tap t sits at k = k0 - t of its group's window); and
// table[512 + g] = j0_g + lead, where group g's A rows start.  Then the
// taps, (t, r) stepped without a division; the compute warps meet at the
// end.
template <class Io>
__device__ __forceinline__ void build_frags(const Io& io, const Plan& p,
                                            uint2* frag, uint2* frr,
                                            int* table, int ctid) {
  const int nct = p.compute_threads;
  const int np = p.up > 1 ? p.up : tc::kN;     // phases (positions at U = 1)
  int* k0 = table + 256;
  for (int i = ctid; i < 32 * p.col_groups * p.ks; i += nct)
    frag[i] = make_uint2(0u, 0u);
  for (int i = ctid; i < 32 * p.ks2; i += nct)
    frr[i] = tc::toeplitz_frag([&](int a) { return io.h2[p.k2 - 1 - a]; },
                               p.k2, 1, i >> 5, i & 31);
  for (int i = ctid; i < np; i += nct) {
    const int pos = p.up > 1 ? i * p.dinv % p.up : i;
    const int g = pos >> 3;
    table[i] = 4 * (32 * g * p.ks + 4 * (pos & 7));
    k0[i] = newest(p, pos) + p.s - group_start(p, g);
  }
  for (int g = ctid; g < p.col_groups; g += nct)
    table[512 + g] = group_start(p, g) + p.lead;
  rational::sync_compute(nct);
  uint16_t* f = reinterpret_cast<uint16_t*>(frag);
  auto put = [&](int at, int k, float v) {
    f[at + 128 * (k >> 4) + 4 * ((k & 7) >> 1) + ((k & 8) >> 2) + (k & 1)] =
        static_cast<uint16_t>(tc::bf16_bits(v));
  };
  if (p.up == 1) {
    for (int i = ctid; i < tc::kN * p.k; i += nct) {
      const int pos = i & (tc::kN - 1);
      const int t = i >> 3;
      put(table[pos], k0[pos] - t, io.h[t]);
    }
    rational::sync_compute(nct);
    return;
  }
  // four taps a 16-byte load where h is 16-byte aligned (U >= 4: a quad
  // wraps past phase U - 1 at most once), kTapUnroll loads in flight
  int i0 = 0;
  if (p.up >= 4 && (reinterpret_cast<uintptr_t>(io.h) & 15) == 0) {
    const int n4 = p.k / 4;
    const int dt = 4 * nct / p.up;
    const int dr = 4 * nct - dt * p.up;
    int t = 4 * ctid / p.up;
    int r = 4 * ctid - t * p.up;
    for (int j4 = ctid; j4 < n4; j4 += kTapUnroll * nct) {
      float4 v[kTapUnroll];
      int tq[kTapUnroll], rq[kTapUnroll];
#pragma unroll
      for (int u = 0; u < kTapUnroll; ++u) {
        if (j4 + u * nct < n4)
          v[u] = reinterpret_cast<const float4*>(io.h)[j4 + u * nct];
        tq[u] = t;
        rq[u] = r;
        t += dt;
        r += dr;
        if (r >= p.up) {
          r -= p.up;
          ++t;
        }
      }
#pragma unroll
      for (int u = 0; u < kTapUnroll; ++u) {
        if (j4 + u * nct < n4) {
          const float vs[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool wrap = rq[u] + e >= p.up;
            const int re = wrap ? rq[u] + e - p.up : rq[u] + e;
            put(table[re], k0[re] - tq[u] - wrap, vs[e]);
          }
        }
      }
    }
    i0 = 4 * n4;
  }
  for (int i = i0 + ctid; i < p.k; i += nct) {
    const int t = i / p.up;
    const int r = i - t * p.up;
    put(table[r], k0[r] - t, io.h[i]);
  }
  rational::sync_compute(nct);
}

// Compute thread `ctid`: the item's resampled outputs.  An M tile is 8
// cycles of one row, leg 0 in rows 0-7 and leg 1 in rows 8-15; a warp
// takes kMq (group, M tile) pairs at once.  out(r, m, v0, v1): output m
// of the item's row r, v0 / v1 its two legs.
template <int kMq, class Out>
__device__ __forceinline__ void resample(const Plan& p, const Item& it,
                                         const uint16_t* win,
                                         const uint2* frag, const int* table,
                                         int ctid, const Out& out) {
  const int warp = ctid >> 5, lane = ctid & 31;
  const int nci = it.c_hi - it.c_lo;
  const int tiles_row = (nci + 7) / 8;           // M tiles a row
  const int pairs = p.col_groups * it.nrows * tiles_row;
  const int lcyc = lane & 7;                     // its ldmatrix row's cycle
  const int lleg = (lane >> 3) & 1;              // and leg
  const int lcol = 8 * (lane >> 4);
  const int gq = lane >> 2, t4 = lane & 3;
  const int stride = (p.compute_threads >> 5) * kMq;
  for (int u0 = warp * kMq; u0 < pairs; u0 += stride) {
    // chain q's A rows from v0 = c*step + j0_g + lead (+ 8): a_at[q] the
    // bf16 of v0's place in `win`, the skew crossed after left[q] more
    // bf16; b_at[q] its group's fragments (32-bit offsets: registers)
    int a_at[kMq], b_at[kMq], left[kMq];
    {
      // pair u = mt * col_groups + g, M tile mt = r * tiles_row + ct,
      // stepped from u0 without a division a pair
      int g = u0 % p.col_groups, mt = u0 / p.col_groups;
      int r = mt / tiles_row, ct = mt - r * tiles_row;
#pragma unroll
      for (int q = 0; q < kMq; ++q) {
        int c = 8 * ct + lcyc;
        c = c < nci ? c : nci - 1;          // a row past the item repeats
        const int k0 = table[512 + g] + lcol;   // < 2 step
        const int wrap = k0 >= p.step;
        a_at[q] = (2 * r + lleg) * p.slen + c * (p.step + p.pad) + k0 +
                  wrap * p.pad;
        left[q] = p.step - (k0 - wrap * p.step);
        b_at[q] = 32 * g * p.ks + lane;
        if (u0 + q + 1 < pairs && ++g == p.col_groups) {
          g = 0;
          if (++ct == tiles_row) {
            ct = 0;
            ++r;
          }
        }
      }
    }
    float acc[kMq][4] = {};
    for (int kk = 0; kk < p.ks; ++kk) {
      // every chain's operands first (inline assembly keeps its order),
      // then the MMAs: one load latency a k-step, not kMq
      unsigned a[kMq][4];
      uint2 b[kMq];
#pragma unroll
      for (int q = 0; q < kMq; ++q) {
        if (u0 + q < pairs) {
          if (tc::kK * kk >= left[q]) {     // past a skew (pad = 0: none)
            a_at[q] += p.pad;
            left[q] += p.step;
          }
          tc::ldsm_x4(a[q], win + a_at[q] + tc::kK * kk);
          b[q] = frag[b_at[q] + 32 * kk];
        }
      }
#pragma unroll
      for (int q = 0; q < kMq; ++q)
        if (u0 + q < pairs) tc::mma(acc[q], a[q], b[q]);
    }
    int g = u0 % p.col_groups, mt = u0 / p.col_groups;
    int r = mt / tiles_row, ct = mt - r * tiles_row;
#pragma unroll
    for (int q = 0; q < kMq; ++q) {
      if (u0 + q < pairs) {
        const int c = 8 * ct + gq;
        if (c < nci) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = 8 * g + 2 * t4 + e;
            if (pos < p.span)
              out(r, (it.c_lo + c) * p.span + pos, acc[q][e], acc[q][2 + e]);
          }
        }
        if (++g == p.col_groups) {
          g = 0;
          if (++ct == tiles_row) {
            ct = 0;
            ++r;
          }
        }
      }
    }
  }
}

// The first and the past-the-end bf16 of the RRC input the item's
// resampler writes (B4): rb[st][q] holds y[e0 - S2 + q], e0 = m0 rounded
// down to 8, for q < valid; the product reads up to nq.
struct RrcSpan {
  int e0, units, valid, nq;
};

__device__ __forceinline__ RrcSpan rrc_span(const Plan& p, const Item& it) {
  RrcSpan r;
  r.e0 = it.m0 & ~7;
  r.units = (it.m1 - r.e0 + tc::kUnit - 1) / tc::kUnit;
  r.valid = p.k2 - 1 + it.m1 - r.e0;
  r.nq = r.units * tc::kUnit - 8 + tc::kK * p.ks2;
  return r;
}

// B4's RRC on the tensor cores, for compute thread `ctid` after the
// resampler has written rb[st][q] for q < valid (and, in tile 0, the
// carried tail below q = S2): zeros up to nq, then the decim-1 Toeplitz
// product of each unit of 128 outputs from e0, kMq units a warp at once,
// outputs [m0, m1) of stream st through out(st)[m].
template <int kMq, class Out>
__device__ __forceinline__ void rrc(const Plan& p, const Item& it,
                                   uint16_t* rb, const uint2* frr,
                                   int ctid, const Out& out) {
  const RrcSpan sp = rrc_span(p, it);
  const int pad = sp.nq - sp.valid;
  for (int i = ctid; i < 2 * it.nrows * pad; i += p.compute_threads) {
    const int st = i / pad;
    rb[st * p.rlen + sp.valid + i - st * pad] = 0;
  }
  rational::sync_compute(p.compute_threads);
  const int warp = ctid >> 5, lane = ctid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int a_off = tc::ldsm_row(lane, tc::kN);  // rows 8 outputs apart
  const int units = 2 * it.nrows * sp.units;
  const int stride = (p.compute_threads >> 5) * kMq;
  for (int u0 = warp * kMq; u0 < units; u0 += stride) {
    int a_row[kMq];                     // bf16 offsets in rb
#pragma unroll
    for (int q = 0; q < kMq; ++q) {
      const int u = u0 + q < units ? u0 + q : units - 1;
      const int st = u / sp.units;
      a_row[q] = st * p.rlen + (u - st * sp.units) * tc::kUnit + a_off;
    }
    float acc[kMq][4] = {};
    for (int kk = 0; kk < p.ks2; ++kk) {
      const uint2 b = frr[32 * kk + lane];
      unsigned a[kMq][4];
#pragma unroll
      for (int q = 0; q < kMq; ++q)
        if (u0 + q < units) tc::ldsm_x4(a[q], rb + a_row[q] + tc::kK * kk);
#pragma unroll
      for (int q = 0; q < kMq; ++q)
        if (u0 + q < units) tc::mma(acc[q], a[q], b);
    }
#pragma unroll
    for (int q = 0; q < kMq; ++q) {
      if (u0 + q < units) {
        const int st = (u0 + q) / sp.units;
        float* o = out(st);
        const int base = sp.e0 + (u0 + q - st * sp.units) * tc::kUnit;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = base + tc::kN * (gq + 8 * (i >> 1)) + 2 * t4 + (i & 1);
          if (m >= it.m0 && m < it.m1) o[m] = acc[q][i];
        }
      }
    }
  }
}

// The ring's named barriers (0 is __syncthreads, 1 the compute warps'
// own, rational::sync_compute): window b full at 2 + b, empty again at
// 2 + kMaxBufs + b, each of all `n` threads of the block, the producers
// arriving, the consumers waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The persistent kernel's body (rational.cuh's run, on the tensor cores):
// the block takes items blockIdx.x, + gridDim.x, ...; its copy warps fill
// a ring of `bufs` windows, item k into window k mod bufs once the compute
// warps have let go of item k - bufs, while the compute warps build the
// fragments and then take the items in turn as each window fills, so the
// copies run up to bufs - 1 items ahead.  Each kernel's __global__
// function (Kernel::tc) runs it; Io::run_tc is the compute warps' part of
// an item.
template <class Io>
__device__ __forceinline__ void run(const Io& io, const Plan& p) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const Layout l = rational_tc::layout(p);
  uint2* frag = reinterpret_cast<uint2*>(base + l.frag);
  uint2* frr = reinterpret_cast<uint2*>(base + l.frr);
  int* table = reinterpret_cast<int*>(base + l.table);
  uint16_t* win = reinterpret_cast<uint16_t*>(base + l.win);
  uint16_t* rb = reinterpret_cast<uint16_t*>(base + l.rb);
  const int tid = threadIdx.x;
  const int buf = 2 * p.rows * p.slen;   // bf16 a window
  const int first = static_cast<int>(blockIdx.x);
  const int step = static_cast<int>(gridDim.x);
  const int mine = first < p.items ? (p.items - first + step - 1) / step : 0;

  if (tid >= p.compute_threads) {
    const int lane = tid - p.compute_threads;
    const int ncopy = p.threads - p.compute_threads;
    // the lead's zeros before slot 0 of every stream of every window
    for (int i = lane; i < 2 * p.rows * p.bufs * p.lead; i += ncopy)
      win[i / p.lead * p.slen + i % p.lead] = 0;
    for (int k = 0; k < mine; ++k) {
      const int b = k % p.bufs;
      if (k >= p.bufs) bar_sync(2 + kMaxBufs + b, p.threads);
      rational_tc::load_window(io, p, rational::item_of(p, first + k * step),
                               win + b * buf, lane, ncopy);
      __threadfence_block();
      bar_arrive(2 + b, p.threads);
    }
  } else {
    rational_tc::build_frags(io, p, frag, frr, table, tid);
    for (int k = 0; k < mine; ++k) {
      const int b = k % p.bufs;
      bar_sync(2 + b, p.threads);        // also: every compute warp is done
                                         // with item k - 1
      io.run_tc(p, rational::item_of(p, first + k * step), win + b * buf,
                frag, frr, table, rb, tid);
      if (k + p.bufs < mine) bar_arrive(2 + kMaxBufs + b, p.threads);
    }
  }
}

// Launches Kernel::tc() (a __global__ function of the Io's file that runs
// `run`) under `p` on `stream`; cudaGetLastError() after it, or
// cudaErrorInvalidValue, launching nothing, for a plan it cannot run.
template <class Kernel, class Io>
int launch(const Io& io, const Plan& p, void* stream) {
  if (p.c <= 0) return 0;
  if (!rational_tc::plan_ok(p) || p.threads > Io::kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = Kernel::tc();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.ctas, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      io, p);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' geometry and plan arguments, in resample_cuda's order
// (_tc_plan_args).
inline Plan make_plan(long long c, int n_in, int up, int down, int k, int k2,
                      int span, int dinv, int ks, int lead, int pad,
                      int reach, int slen, int rows, int cycles, int n_tiles,
                      int halo_cycles, int rlen, int ystride, int bufs,
                      int compute_threads, int threads, int ctas, int items,
                      int smem) {
  Plan p{};
  p.c = c;
  p.n_in = n_in;
  p.m_out = static_cast<int>(static_cast<long long>(n_in) * up / down);
  p.up = up;
  p.down = down;
  p.k = k;
  p.k2 = k2;
  p.span = span;
  p.step = up >= 1 && span % up == 0 ? span / up * down : 0;
  p.s = (k - 1) / up;
  p.taps = p.s + 1;
  p.dinv = dinv;
  p.col_groups = (span + tc::kN - 1) / tc::kN;
  p.ks = ks;
  p.ks2 = k2 ? tc::ksteps(1, k2) : 0;
  p.lead = lead;
  p.pad = pad;
  p.reach = reach;
  p.step_inv = p.step > 0 ? static_cast<unsigned>(
                                ((1ULL << 32) + p.step - 1) / p.step)
                          : 0;
  p.slen = slen;
  p.rows = rows;
  p.cycles = cycles;
  p.n_tiles = n_tiles;
  p.halo_cycles = halo_cycles;
  p.rlen = rlen;
  p.ystride = ystride;
  p.bufs = bufs;
  p.compute_threads = compute_threads;
  p.threads = threads;
  p.ctas = ctas;
  p.items = items;
  p.smem = smem;
  return p;
}

}  // namespace rational_tc
