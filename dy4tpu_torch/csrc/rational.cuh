// The polyphase tile resampler shared by B4 (rds_backend.cu), B5
// (audio_rational.cu) and, as its decimating case U = 1, B3 (the same
// entry as B5): the rational U/D resampler with carried tails over C rows,
// each kernel adding its own input mix and epilogue (an Io class).
//
// The resampler.  With x_ext = [tail || x] (S + N samples), S = (K-1)//U,
// output m of a row is (dy4tpu/ops/fir.py, the port's fir.py)
//   y[m] = sum_{t=0..S} x_ext[S + (m*D)//U - t] * h[r + t*U],
// r = (m*D) % U, a tap index >= K contributing nothing.  gcd(U, D) = 1,
// so a row of N inputs is N/D whole phase cycles of U outputs: output
// m = c*U + p (cycle c, position p) takes phase r_p = (p*D) % U and its
// newest input is S + c*D + b_p, b_p = (p*D)//U.  Each position occurs
// once a cycle, and its outputs step through the input by exactly D.
//
// The walk's cycle is `span` outputs and `step` inputs: one phase cycle
// (U, D) where U > 1.  With U = 1 a phase cycle is one output, so the walk
// takes `span` consecutive outputs as its cycle (step = span * D): output
// p of it is position p, b_p = p * D, and every position takes all of h.
//
// The launch (resample_cuda._tile_plan sizes it; Plan below), one block
// an SM:
//   * persistent blocks walk work items it, it + gridDim.x, ...: an item
//     is `rows` rows times a tile of `cycles` whole cycles (the last tile
//     of a row may be shorter);
//   * copy warps, the block's last threads, load the next item's input
//     windows into the other of two buffers while the compute warps work
//     on this one, mixing as they load (Io::fetch, Io::mix) and storing
//     both streams of a row interleaved as float2, 16 bytes a load where
//     the inputs allow; the carried tail fills the window's first S
//     samples in tile 0;
//   * a compute thread owns a tuple of P consecutive positions and
//     accumulates `chunk` (QT) consecutive cycles of one row's two
//     streams at once, units j, j + groups, ... of the item.  The P
//     positions' newest inputs lie within a few samples of one another,
//     so each tap row is stored shifted (zero taps before and after) to
//     line all P up on the tuple's anchor, its newest input: at step tau
//     every position reads the same input.  One 8-byte read of the window
//     then feeds 2 x P FMAs, one 16-byte read of a tap row four steps of
//     one position, and a step of a thread 2 x P x QT FMAs;
//   * at U = 1 every tuple's newest input sits at the same place mod D,
//     so at even D a warp's window reads would share a few banks: tuple k
//     reads lead(k) = (k / lead_group) % lead_mod steps ahead of its
//     newest input (lead_mod <= D, so never past the window's end), its
//     rows shifted that much further, which puts the warp's reads on
//     distinct banks (the plan picks lead_group and lead_mod; B4 and B5
//     take no lead);
//   * the taps are staged once a block: h read in natural order and
//     scattered to its (position, tuple) row while the copy warps load
//     the first item.  Lane l of a warp takes tuple (l * tmul) mod tuples
//     (tmul chosen by the plan so that a warp's window reads fall on
//     distinct banks; consecutive phases in the first design were the
//     case P = 1, tmul = D^-1 mod U), and the tap rows are stored in lane
//     order with a stride of 4 x an odd number of floats, so the 16-byte
//     tap reads of a quarter-warp never share a bank.  At U = 1 the
//     tuples of one lead have the same rows, so they share them: `hrows`
//     rows a position, one a lead, and a warp's tap reads are broadcasts
//     of at most lead_mod rows;
//   * the epilogue (Io::epilogue) runs on the compute threads after a
//     named barrier of theirs; one __syncthreads of the whole block ends
//     an item and hands the buffers over.
//
// Precision.  This float32 walk is the "highest" path; at dy4tpu's
// mm_dtype=bf16 (precision "default" / "high", ops/precision.py) the
// kernels run rational_tc.cuh's tensor-core design instead, which shares
// this file's Plan, items and tails.
//
// Numerics: every output is one chain of fmaf over its taps t = 0..S in
// that order, from +0, whatever the plan: a zero tap of a shifted row
// adds 0 * x, which leaves a sum that starts at +0 (and so is never -0)
// bit for bit unchanged for finite x.  An output, a recomputed halo
// output among them, has the same bits under every plan.  The mixes are
// the plain versions' products in their order, so the carried input
// tails are exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rational {

constexpr int kMaxThreads = 512;   // resample_cuda.MAX_THREADS: 128
                                   // registers a thread, one block an SM
constexpr int kRrcGroup = 9;       // resample_cuda.RRC_GROUP
constexpr int kCopyUnroll = 8;     // 4-byte loads of an input a copy
constexpr int kVecUnroll = 4;      // thread keeps in flight; 16-byte ones

// The geometry and resample_cuda.TilePlan, as the entry points take them.
struct Plan {
  long long c;        // rows
  int n_in, m_out;    // inputs and outputs a row
  int up, down, k;    // U, D, taps
  int span, step;     // outputs and inputs a cycle of the walk (the note)
  int s, taps;        // tail length S = (K-1)//U; taps a phase = S + 1
  int k2;             // RRC taps (B4), 0 for B5
  int dinv;           // D^-1 mod U: the position of phase r
  int phases;         // P: positions a tuple holds
  int tuples;         // ceil(span / P)
  int tmul, tinv;     // lane l takes tuple (l * tmul) mod tuples; its
                      // inverse mod tuples
  int lead_group, lead_mod;   // tuple k's lead (the note)
  int hrows;          // tap rows a position: tuples, or at U = 1 leads
  int lx, lxs;        // steps a tuple's loop takes (S + 1 + the widest
                      // shift); floats a shifted tap row takes
  int guard;          // zero float2 before each window row (>= the shift)
  int rows, cycles, n_tiles, halo_cycles;
  int window;         // float2 a row's input window holds (even)
  int ystride, yhead; // floats a staged stream holds; where its tile starts
  int chunk, groups, compute_threads, threads, ctas, items, smem;
  // the tensor-core design only (rational_tc.cuh; 0 in this walk's plans)
  int col_groups;     // groups of 8 positions: ceil(span / 8)
  int ks, ks2;        // k-steps of a group's product and of B4's RRC
  int lead;           // bf16 zeros before window slot 0: (-S) mod 8
  int pad, reach;     // the window's skew every step; a cycle row's reads
  unsigned step_inv;  // ceil(2^32 / step): v / step as a multiply
  int slen, rlen;     // bf16 of a stream's window, of its RRC input
  int bufs;           // windows in the ring
};

__host__ __device__ inline int r4(int n) { return (n + 3) / 4 * 4; }

// A tap row of `n` floats padded to 4 x an odd number, so a quarter-warp
// of consecutive rows reads 16 bytes each from distinct banks.
__host__ __device__ inline int tap_stride(int n) {
  const int q = (n + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}

// Shared memory, in floats (resample_cuda._layout): the shifted tap rows
// [P][hrows], the RRC taps, two input windows (each row behind its
// guard), the staged streams, B4's RRC outputs (its two half sums).
struct Layout {
  int hp, hr, xw, ye, bb, total;
};

__host__ __device__ inline Layout layout(const Plan& p) {
  Layout l;
  l.hp = 0;
  l.hr = p.phases * p.hrows * p.lxs;
  l.xw = l.hr + r4(p.k2);
  l.ye = l.xw + 2 * p.rows * (p.guard + p.window) * 2;
  l.bb = l.ye + 2 * p.rows * p.ystride;
  l.total = l.bb + (p.k2 ? 4 * p.rows * r4(p.cycles * p.span) : 0);
  return l;
}

__host__ __device__ inline int lead(const Plan& p, int k) {
  return k / p.lead_group % p.lead_mod;
}

// Tuple k's tap row among a position's hrows: its lane (U > 1), its lead
// (U = 1).
__host__ __device__ inline int tap_slot(const Plan& p, int k) {
  return p.up > 1 ? static_cast<int>(static_cast<long long>(k) * p.tinv %
                                     p.tuples)
                  : lead(p, k);
}

// Tuple k's anchor: b_p of its last position, plus its lead.
__host__ __device__ inline int tuple_anchor(const Plan& p, int k) {
  int last = (k + 1) * p.phases - 1;
  if (last > p.span - 1) last = p.span - 1;
  return static_cast<int>(static_cast<long long>(last) * p.step / p.span) +
         lead(p, k);
}

// The widest shift of a tap row: its tuple's anchor less b_p of its first
// position (lx must hold it after the S + 1 taps).
inline int widest_shift(const Plan& p) {
  int w = 0;
  for (int k = 0; k < p.tuples; ++k) {
    const int first = static_cast<int>(static_cast<long long>(k) *
                                       p.phases * p.step / p.span);
    if (tuple_anchor(p, k) - first > w) w = tuple_anchor(p, k) - first;
  }
  return w;
}

// A plan the kernel cannot run is refused before the launch.
inline bool plan_ok(const Plan& p) {
  if (!(p.up >= 1 && p.down >= 1 && p.phases >= 1 && p.phases <= 4 &&
        p.span >= 1 && (p.span == p.up || p.up == 1) &&
        p.lead_group >= 1 && p.lead_mod >= 1 &&
        (p.lead_mod == 1 || (p.up == 1 && p.lead_mod <= p.down)) &&
        p.tuples == (p.span + p.phases - 1) / p.phases))
    return false;
  const int cycles_row = p.n_in / p.step;
  return p.n_in % p.step == 0 &&
         p.rows >= 1 && p.cycles >= 1 && p.cycles <= cycles_row &&
         p.n_tiles == (cycles_row + p.cycles - 1) / p.cycles &&
         p.items == (p.c + p.rows - 1) / p.rows * p.n_tiles &&
         (p.n_tiles == 1 || p.k2 == 0 ||
          (p.halo_cycles * p.span >= p.k2 - 1 &&
           p.cycles >= p.halo_cycles)) &&
         p.tmul >= 0 && p.tmul < p.tuples && p.tinv >= 0 &&
         p.tinv < p.tuples &&
         (static_cast<long long>(p.tmul) * p.tinv) % p.tuples ==
             (p.tuples > 1 ? 1 : 0) &&
         p.lx >= p.taps + widest_shift(p) && p.lxs == tap_stride(p.lx) &&
         p.guard % 2 == 0 && p.guard >= p.lx - p.taps &&
         p.chunk >= 1 && p.chunk <= 4 && p.groups >= 1 &&
         p.compute_threads % 32 == 0 &&
         p.compute_threads >= p.tuples * p.groups &&
         p.threads > p.compute_threads && p.threads % 32 == 0 &&
         p.threads <= kMaxThreads && p.ctas >= 1 && p.ctas <= p.items &&
         p.window % 2 == 0 &&
         p.window >= p.s + (p.cycles + p.halo_cycles) * p.step &&
         p.yhead >= p.halo_cycles * p.span &&
         (p.k2 == 0 || p.yhead >= p.k2 - 1) &&
         p.ystride >= p.yhead + p.cycles * p.span + (p.k2 ? kRrcGroup : 0) &&
         4 * layout(p).total == p.smem;
}

// Work item `it`: rows [row0, row0 + nrows) and outputs [m0, m1) of
// tile `tile`; its resampler runs cycles [c_lo, c_hi), the halo's first.
struct Item {
  long long row0;
  int nrows, tile, m0, m1, c_lo, c_hi;
};

__device__ __forceinline__ Item item_of(const Plan& p, int it) {
  Item i;
  const int g = it / p.n_tiles;
  i.tile = it - g * p.n_tiles;
  i.row0 = static_cast<long long>(g) * p.rows;
  const long long left = p.c - i.row0;
  i.nrows = left < p.rows ? static_cast<int>(left) : p.rows;
  i.m0 = i.tile * p.cycles * p.span;
  const int m1 = i.m0 + p.cycles * p.span;
  i.m1 = m1 < p.m_out ? m1 : p.m_out;
  i.c_lo = i.tile * p.cycles - (i.tile ? p.halo_cycles : 0);
  i.c_hi = i.m1 / p.span;
  return i;
}

// The compute warps' own barrier (named barrier 1).
__device__ __forceinline__ void sync_compute(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Copy thread `lane` of `n`: the input windows of item `it` into `xw` (a
// buffer's first row, after its guard): window slot u of a row is
// x_ext[c_lo*step + u], both streams mixed.  The slots before u0 come from
// the carried tail (a tile that starts less than S samples into the row:
// tile 0, and at U = 1 a short tile after it); the body (slots from u0
// on, the row's own samples) goes 16 bytes a load where the three inputs
// and the slot are 16-byte aligned, else 4.
template <class Io>
__device__ __forceinline__ void load_window(const Io& io, const Plan& p,
                                            const Item& it, float2* xw,
                                            int lane, int n) {
  const int len = p.s + (it.c_hi - it.c_lo) * p.step;
  const long long wx0 = static_cast<long long>(it.c_lo) * p.step;
  const int u0 = wx0 < p.s ? p.s - static_cast<int>(wx0) : 0;
  for (int r = 0; r < it.nrows; ++r) {
    const long long row = it.row0 + r;
    float2* dst = xw + r * (p.guard + p.window);
    for (int u = lane; u < u0; u += n)
      dst[u] = io.tail(row, static_cast<int>(wx0) + u, p.s);
    const long long xb = row * p.n_in + wx0 - p.s;
    int u = u0;
    if (u0 % 4 == 0 && io.aligned(xb + u0)) {
      const int len4 = u0 + (len - u0) / 4 * 4;
      for (u = u0 + 4 * lane; u < len4; u += 4 * n * kVecUnroll) {
        float4 a[kVecUnroll], b[kVecUnroll], c[kVecUnroll];
#pragma unroll
        for (int q = 0; q < kVecUnroll; ++q) {
          const int v = u + 4 * q * n;
          if (v < len4) io.fetch4(xb + v, a[q], b[q], c[q]);
        }
#pragma unroll
        for (int q = 0; q < kVecUnroll; ++q) {
          const int v = u + 4 * q * n;
          if (v < len4) {
            const float2 m0 = io.mix(a[q].x, b[q].x, c[q].x);
            const float2 m1 = io.mix(a[q].y, b[q].y, c[q].y);
            const float2 m2 = io.mix(a[q].z, b[q].z, c[q].z);
            const float2 m3 = io.mix(a[q].w, b[q].w, c[q].w);
            float4* d = reinterpret_cast<float4*>(dst + v);
            d[0] = make_float4(m0.x, m0.y, m1.x, m1.y);
            d[1] = make_float4(m2.x, m2.y, m3.x, m3.y);
          }
        }
      }
      u = len4;
    }
    for (u += lane; u < len; u += n * kCopyUnroll) {
      float a[kCopyUnroll], b[kCopyUnroll], c[kCopyUnroll];
#pragma unroll
      for (int q = 0; q < kCopyUnroll; ++q) {
        const int v = u + q * n;
        if (v < len) io.fetch(xb + v, a[q], b[q], c[q]);
      }
#pragma unroll
      for (int q = 0; q < kCopyUnroll; ++q) {
        const int v = u + q * n;
        if (v < len) dst[v] = io.mix(a[q], b[q], c[q]);
      }
    }
  }
}

// Compute thread `ctid`: the new input tails of the item's rows, the last
// S mixed samples of each (a and b: the two streams), from the window,
// where the item is its row's last tile.
__device__ __forceinline__ void store_input_tails(const Plan& p,
                                                  const Item& it,
                                                  const float2* xw,
                                                  float* out_a, float* out_b,
                                                  int ctid) {
  if (it.c_hi * p.step != p.n_in) return;
  const int w0 = p.n_in - it.c_lo * p.step;   // window slot of x_ext[n]
  for (int i = ctid; i < it.nrows * p.s; i += p.compute_threads) {
    const int r = i / p.s;
    const int j = i - r * p.s;
    const long long row = it.row0 + r;
    const float2 v = xw[r * (p.guard + p.window) + w0 + j];
    out_a[row * p.s + j] = v.x;
    out_b[row * p.s + j] = v.y;
  }
}

// Compute thread `ctid`: the zeroed tap rows and window guards, where
// each position's shifted row starts (in `scratch`, which the first item
// overwrites; entry c * U + r for the c-th position of phase r, which is
// r itself where span = U), and then the taps of h, read in natural
// order, each into its phase's rows.
template <class Io>
__device__ __forceinline__ void stage_taps(const Io& io, const Plan& p,
                                           float* hp, float* hr, float2* xw,
                                           int* scratch, int ctid) {
  const int nct = p.compute_threads;
  for (int j = ctid; j < p.phases * p.hrows * p.lxs; j += nct) hp[j] = 0.0f;
  for (int j = ctid; j < 2 * p.rows * p.guard; j += nct) {
    const int r = j / p.guard;
    xw[r * (p.guard + p.window) + j - r * p.guard] = make_float2(0.0f, 0.0f);
  }
  for (int j = ctid; j < p.k2; j += nct) hr[j] = io.h2[j];
  for (int q = ctid; q < p.span; q += nct) {
    const int r = q % p.up;
    const int pos = static_cast<int>(static_cast<long long>(r) * p.dinv %
                                     p.up) + q - r;
    const int k = pos / p.phases;
    const int shift = tuple_anchor(p, k) -
        static_cast<int>(static_cast<long long>(pos) * p.step / p.span);
    scratch[q] = ((pos - k * p.phases) * p.hrows + tap_slot(p, k)) * p.lxs +
                 shift;
  }
  sync_compute(nct);
  // tap j = r + t*U, 16 bytes a load where h is 16-byte aligned: (r, t)
  // stepped without a division
  int j0 = 0;
  if (p.up >= 4 && (reinterpret_cast<uintptr_t>(io.h) & 15) == 0) {
    const int n4 = p.k / 4;
    const int dt = 4 * nct / p.up;
    const int dr = 4 * nct - dt * p.up;
    int t = 4 * ctid / p.up;
    int r = 4 * ctid - t * p.up;
#pragma unroll 8
    for (int j4 = ctid; j4 < n4; j4 += nct) {
      const float4 v = reinterpret_cast<const float4*>(io.h)[j4];
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = r + i < p.up ? r + i : r + i - p.up;
        hp[scratch[ri] + t + (r + i < p.up ? 0 : 1)] = vs[i];
      }
      t += dt;
      r += dr;
      if (r >= p.up) {
        r -= p.up;
        ++t;
      }
    }
    j0 = 4 * n4;
  }
  for (int j = j0 + ctid; j < p.k; j += nct) {
    const int t = j / p.up;
    for (int q = j - t * p.up; q < p.span; q += p.up)
      hp[scratch[q] + t] = io.h[j];
  }
}

// Compute thread `ctid`: the resampled outputs of item `it` into ye, at
// ye[stream * ystride + yhead + (m - m0)], stream 2*row + leg.
template <int P, int QT>
__device__ __forceinline__ void resample(const Plan& p, const Item& it,
                                         const float2* xw, const float* hp,
                                         float* ye, int ctid) {
  const int lane = ctid % p.tuples;
  const int j = ctid / p.tuples;
  if (j >= p.groups) return;
  const int k = static_cast<int>(static_cast<long long>(lane) * p.tmul %
                                 p.tuples);
  const float* h = hp + tap_slot(p, k) * p.lxs;
  const int rstride = p.hrows * p.lxs;     // one position's row to the next
  const int nci = it.c_hi - it.c_lo;
  const int nch = (nci + QT - 1) / QT;
  const int units = it.nrows * nch;
  const int ybase =
      p.yhead + (it.c_lo - it.tile * p.cycles) * p.span + k * P;
  const int newest = p.s + tuple_anchor(p, k);
  for (int u = j; u < units; u += p.groups) {
    const int row = u / nch;
    const int c0 = (u - row * nch) * QT;
    const float2* x = xw + row * (p.guard + p.window) + newest;
    const float2* xq[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      // a unit past the item's last cycle repeats it and stores nothing
      const int cq = c0 + q < nci ? c0 + q : nci - 1;
      xq[q] = x + cq * p.step;
    }
    float a0[P][QT], a1[P][QT];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int q = 0; q < QT; ++q) a0[i][q] = a1[i][q] = 0.0f;
    // four steps a turn: their reads all issued before the turn's FMAs
    int t = 0;
    for (; t + 4 <= p.lx; t += 4) {
      float hv[P][4];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float4 h4 =
            *reinterpret_cast<const float4*>(h + i * rstride + t);
        hv[i][0] = h4.x;
        hv[i][1] = h4.y;
        hv[i][2] = h4.z;
        hv[i][3] = h4.w;
      }
      float2 v[4][QT];
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
        for (int q = 0; q < QT; ++q) v[s4][q] = xq[q][-(t + s4)];
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
          for (int q = 0; q < QT; ++q) {
            a0[i][q] = __fmaf_rn(hv[i][s4], v[s4][q].x, a0[i][q]);
            a1[i][q] = __fmaf_rn(hv[i][s4], v[s4][q].y, a1[i][q]);
          }
    }
    for (; t < p.lx; ++t) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float hv = h[i * rstride + t];
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const float2 v = xq[q][-t];
          a0[i][q] = __fmaf_rn(hv, v.x, a0[i][q]);
          a1[i][q] = __fmaf_rn(hv, v.y, a1[i][q]);
        }
      }
    }
    float* y0 = ye + 2 * row * p.ystride + ybase;
    float* y1 = y0 + p.ystride;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (k * P + i < p.span) {
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          if (c0 + q < nci) {
            y0[(c0 + q) * p.span + i] = a0[i][q];
            y1[(c0 + q) * p.span + i] = a1[i][q];
          }
        }
      }
    }
  }
}

// The persistent kernel's body, a block's whole life: taps once, then the
// item walk (see the note).  Each kernel's __global__ function (Kernel::fn
// below) runs it for its own Io.
template <class Io, int P, int QT>
__device__ __forceinline__ void run(const Io& io, const Plan& p) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout(p);
  float* hp = smem + l.hp;
  float* hr = smem + l.hr;
  float2* xw = reinterpret_cast<float2*>(smem + l.xw);
  float* ye = smem + l.ye;
  float* bb = smem + l.bb;
  const int tid = threadIdx.x;
  const bool copier = tid >= p.compute_threads;
  const int lane = tid - p.compute_threads;
  const int ncopy = p.threads - p.compute_threads;
  const int buf = p.rows * (p.guard + p.window);   // float2 a buffer

  if (copier) {
    if (static_cast<int>(blockIdx.x) < p.items)
      load_window(io, p, item_of(p, blockIdx.x), xw + p.guard, lane, ncopy);
  } else {
    stage_taps(io, p, hp, hr, xw, reinterpret_cast<int*>(ye), tid);
  }
  __syncthreads();

  int k = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x, ++k) {
    const float2* cur = xw + (k & 1) * buf + p.guard;
    if (copier) {
      const int next = it + static_cast<int>(gridDim.x);
      if (next < p.items)
        load_window(io, p, item_of(p, next),
                    xw + ((k + 1) & 1) * buf + p.guard, lane, ncopy);
    } else {
      const Item item = item_of(p, it);
      io.prologue(p, item, ye, tid);
      resample<P, QT>(p, item, cur, hp, ye, tid);
      sync_compute(p.compute_threads);
      io.epilogue(p, item, cur, hr, ye, bb, tid);
    }
    __syncthreads();
  }
}

// Launches Kernel::fn<P, QT>() (a __global__ function of the Io's file
// that runs `run`) under `p` on `stream`; cudaGetLastError() after it.
template <class Kernel, class Io, int P, int QT>
int launch_with(const Io& io, const Plan& p, void* stream) {
  auto kernel = Kernel::template fn<P, QT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.ctas, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      io, p);
  return static_cast<int>(cudaGetLastError());
}

// The (P, QT) instantiations: resample_cuda.SHAPES.
template <class Kernel, class Io>
int launch(const Io& io, const Plan& p, void* stream) {
  if (p.c <= 0) return 0;
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.phases * 8 + p.chunk) {
    case 9: return launch_with<Kernel, Io, 1, 1>(io, p, stream);
    case 10: return launch_with<Kernel, Io, 1, 2>(io, p, stream);
    case 11: return launch_with<Kernel, Io, 1, 3>(io, p, stream);
    case 12: return launch_with<Kernel, Io, 1, 4>(io, p, stream);
    case 17: return launch_with<Kernel, Io, 2, 1>(io, p, stream);
    case 18: return launch_with<Kernel, Io, 2, 2>(io, p, stream);
    case 19: return launch_with<Kernel, Io, 2, 3>(io, p, stream);
    case 25: return launch_with<Kernel, Io, 3, 1>(io, p, stream);
    case 26: return launch_with<Kernel, Io, 3, 2>(io, p, stream);
    case 33: return launch_with<Kernel, Io, 4, 1>(io, p, stream);
    case 34: return launch_with<Kernel, Io, 4, 2>(io, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Thread blocks an SM of Kernel::fn<P, QT>() (the float32 walk at plan
// shape (phases, chunk)), or of Kernel::tc() (rational_tc.cuh) where tc
// != 0, at `threads` threads and `smem` bytes of dynamic shared memory, as
// the card's occupancy calculator counts them; a negative cudaError on
// failure or for a shape not instantiated.  For reports.
template <class Kernel>
int blocks(int tc, int phases, int chunk, int threads, long long smem) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto count = [&](auto kernel) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, threads, static_cast<size_t>(smem));
  };
  if (tc) {
    count(Kernel::tc());
  } else {
    switch (phases * 8 + chunk) {
      case 9: count(Kernel::template fn<1, 1>()); break;
      case 10: count(Kernel::template fn<1, 2>()); break;
      case 11: count(Kernel::template fn<1, 3>()); break;
      case 12: count(Kernel::template fn<1, 4>()); break;
      case 17: count(Kernel::template fn<2, 1>()); break;
      case 18: count(Kernel::template fn<2, 2>()); break;
      case 19: count(Kernel::template fn<2, 3>()); break;
      case 25: count(Kernel::template fn<3, 1>()); break;
      case 26: count(Kernel::template fn<3, 2>()); break;
      case 33: count(Kernel::template fn<4, 1>()); break;
      case 34: count(Kernel::template fn<4, 2>()); break;
      default: break;
    }
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The entry points' geometry and plan arguments, in resample_cuda's order.
inline Plan make_plan(long long c, int n_in, int up, int down, int k, int k2,
                      int span, int dinv, int phases, int tmul, int tinv,
                      int lead_group, int lead_mod, int lx,
                      int guard, int rows, int cycles, int n_tiles,
                      int halo_cycles, int window, int ystride, int yhead,
                      int chunk, int groups, int compute_threads,
                      int threads, int ctas, int items, int smem) {
  Plan p{};
  p.c = c;
  p.n_in = n_in;
  p.m_out = static_cast<int>(static_cast<long long>(n_in) * up / down);
  p.up = up;
  p.down = down;
  p.k = k;
  p.span = span;
  p.step = up >= 1 && span % up == 0 ? span / up * down : 0;
  p.s = (k - 1) / up;
  p.taps = p.s + 1;
  p.k2 = k2;
  p.dinv = dinv;
  p.phases = phases;
  p.tuples = phases >= 1 ? (span + phases - 1) / phases : 0;
  p.tmul = tmul;
  p.tinv = tinv;
  p.lead_group = lead_group;
  p.lead_mod = lead_mod;
  p.hrows = up > 1 ? p.tuples : lead_mod;
  p.lx = lx;
  p.lxs = tap_stride(lx);
  p.guard = guard;
  p.rows = rows;
  p.cycles = cycles;
  p.n_tiles = n_tiles;
  p.halo_cycles = halo_cycles;
  p.window = window;
  p.ystride = ystride;
  p.yhead = yhead;
  p.chunk = chunk;
  p.groups = groups;
  p.compute_threads = compute_threads;
  p.threads = threads;
  p.ctas = ctas;
  p.items = items;
  p.smem = smem;
  return p;
}

}  // namespace rational
