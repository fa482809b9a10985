// The whole LTI front half of one receiver block, time-tiled: a thread
// block owns the decimated outputs [m0, m1) of one channel row.  Two
// kernels share every stage after the FM demod's input.
//
// B1 frontend_full_kernel replaces dy4tpu/ops/frontend_pallas.py ::
// fused_frontend_full (_kernel_front_full, _band_stages).  Per row:
//   1. u8 -> (x-128)/128, I/Q deinterleave, 101-tap RF LPF decimating by
//      `decim` on both legs, over [iq_tail || block]
//   2. the differentiator demod, with prev_i/prev_q carried and the
//      zero-power guard
//   3. the pilot / stereo (/ RDS-band) bank, one shared history, and the
//      mono delay
//   4. (RDS only) squaring, the 114 kHz carrier BPF, and the RDS delay
// B1 with kCorr is the same kernel with fused_frontend_full's `corr`
// epilogue (the narrowband IQ tracker): after stage 1 it takes the 14
// conic-fit moments E[i^p q^r] (order <= 4, iqcorr.py's _POWERS order) of
// the tile's decimated I/Q before the correction, and applies i -= dc_i;
// q = (q - dc_q - rho*i)*s to every I/Q sample it computed, halo too,
// before the demod.
// B6 frontend_if_kernel replaces fused_frontend_if (_kernel_front_if): its
// stage 1 reads float32 IF I/Q rows (a channelizer's output, already band-
// limited and decimated) instead of running the u8 read and the RF LPF;
// stages 2-4 are the same device routine, band_stages<kRds, kBf16>.  Both
// kernels are templated on RDS: without it the bank has two rows, stage 4
// is skipped, and neither the carrier taps nor the RDS tails and outputs
// are touched (their pointers may be null).  And on kBf16, dy4tpu's
// mm_dtype=bf16 (precision "default" / "high", ops/precision.py): the bank
// reads fm rounded to bf16 and the carrier BPF the squared RDS band
// rounded to bf16, as dy4tpu's _band_stages casts both before its dots;
// the wrapper passes bf16-rounded taps (the RF taps too: the u8 window is
// exact in bf16, so the RF stage needs no change).  The mono and RDS
// delays and every carried tail stay float32.
//
// What bounds it on the card: the float32 multiply-adds (2 x 101 per IF
// sample for the RF legs, 4 x 101 for the bank and the carrier); the u8
// read (153,600 bytes a row at mode 0) is the only stream from device
// memory that scales with the input.  The design:
//
//  * Grid (row, tile).  A tile is `tile` decimated outputs (the wrapper's
//    plan, frontend_cuda._tile_plan: 1536), so shared memory scales with
//    the tile, not the row (about 52 KB a block for B1 at mode 0, 22 KB
//    for B6), B1's registers are capped for 3 blocks of 256 threads an SM,
//    and one row spreads over n_out / tile SMs.  A tile
//    recomputes a halo of `halo` samples before m0: 2*(kb-1)+1 with RDS
//    (the carrier BPF needs kb-1 squared RDS-band samples, the bank kb-1
//    fm samples, the demod one I/Q sample), kb without.  tile >= halo, so
//    only tile 0 reads the carried state (prev_i/prev_q, bank_tail,
//    carrier_tail, mono_delay, rds_delay), and the last tile writes every
//    new tail from its own halo-extended buffers.  Every output is summed
//    tap by tap in one fixed order, so a recomputed halo sample equals the
//    one its own tile computes.
//  * Stage 1 is rf_stage.cuh's RF stage (shared with B11-B13 in
//    frontend_rf.cu): passes of `sub` outputs over a window of the row in
//    polyphase order, filled from 16-bit I/Q pairs prefetched into
//    registers while the last pass multiplies.  Stage 2 is its demod.
//  * Every MAC stage is register-blocked (rf_stage.cuh's mac4): a thread
//    makes kR = 4 consecutive outputs from one window that slides through
//    registers, 16 bytes a load, with each tap broadcast to the 4 outputs
//    (and, in the bank, one window shared by its 2 or 3 filters).  So a
//    warp's float4 window loads hit all 32 banks once, and a tap feeds 4
//    FMAs.  Taps are padded with zeros to a multiple of 4 (a phase's to
//    nq).
//  * The corr moments cover [m0, m1) only: per-thread sums over a stride,
//    a warp shuffle tree, the warps in order, into partial[row, tile]; the
//    row's last block to finish (a ticket from an integer atomic, the
//    partials fenced) sums the tiles in tile order and divides by n_out.
//    No float atomics, so the result is the same on every run.
//
// Numerics: the normalize is done first, (x-128)/128, which is exact in
// float32 (the TPU kernel's -128*sum(h) epilogue is an MXU device that
// cancels in float32 and is not copied).  The sums run tap by tap with
// FMAs, so results match the plain torch version to float32 tolerance,
// not bitwise; iq_tail comes straight from the raw block, and B6's
// prev_i/prev_q straight from its input, so both are exact.  The demod is
// rf_stage.cuh's fm_demod, each operation rounded on its own, so B1's I/Q
// and fm are B11's (frontend_rf.cu) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rf_stage.cuh"

namespace {

using rf::kR;
using rf::kRound;
using rf::kThreads;
using rf::mac4;
using rf::norm;
using rf::round4;
using rf::window_row;

constexpr int kWarps = kThreads / 32;
constexpr int kFullBlocks = 3;  // B1 blocks an SM: 80 registers a thread
constexpr int kMoments = 14;  // IQ-tracker moments (corr epilogue)

// rf::Geometry: n_in, decim, s_rf (k_rf - 1; 0 for the IF entry), sub (RF
// outputs a pass), nq (taps a polyphase row, padded to 4), lp (window row,
// floats).
struct Geometry : rf::Geometry {
  long long bs;    // u8 bytes per row (I and Q interleaved); 2*n_out for B6
  int n_out;       // IF samples = n_in / decim
  int k_rf;        // RF LPF taps; 0 for the IF entry (no RF stage)
  int kb;          // band / carrier taps
  int s_b;         // kb - 1: band history
  int dly;         // kb / 2: mono and RDS delays
  int tile;        // outputs a tile owns
  int n_tiles;     // tiles a row
  int halo;        // I/Q samples a tile recomputes before m0
  int kp;          // band taps padded to 4
  int l_iq;        // floats of each I/Q buffer
  int l_fm;        // floats of the fm buffer
};

Geometry make_geometry(long long bs, int decim, int k_rf, int kb, bool rds,
                       int tile, int sub) {
  Geometry g;
  g.bs = bs;
  g.n_in = static_cast<int>(bs / 2);
  g.n_out = g.n_in / decim;
  g.decim = decim;
  g.k_rf = k_rf;
  g.s_rf = k_rf ? k_rf - 1 : 0;
  g.kb = kb;
  g.s_b = kb - 1;
  g.dly = kb / 2;
  g.tile = tile;
  g.n_tiles = (g.n_out + tile - 1) / tile;
  g.halo = rds ? 2 * g.s_b + 1 : kb;
  g.sub = k_rf ? sub : 0;
  g.nq = k_rf ? round4(g.s_rf / decim + 1) : 0;
  g.lp = k_rf ? window_row(sub + g.nq) : 0;
  g.kp = round4(kb);
  g.l_iq = round4(tile + g.halo);
  g.l_fm = round4(tile + (rds ? g.s_b : 0)) + g.kp + 4;
  return g;
}

bool plan_ok(const Geometry& g) {
  return g.tile >= g.halo && g.tile % 4 == 0 &&
         (!g.k_rf || (g.sub >= kR && g.sub % kR == 0 &&
                      g.decim * (g.sub + g.nq) <= kRound));
}

// Shared-memory layout, in floats, in this order (each a multiple of 4):
//   hs [decim, nq]     RF taps by phase, hs[r][q] = h[s - q*D - r] (B1)
//   hb [nb, kp]        bank taps reversed, hb[f][a] = h_bank[f][kb-1-a]
//   hc [kp]            carrier taps reversed (RDS only)
//   iq_i, iq_q [l_iq]  the tile's I/Q; then the RDS band and
//                      [carrier_tail || its square]
//   u                  the RF window [2, decim, lp] (B1), then
//                      fm_ext [bank_tail || fm]
//   red [kMoments, kWarps] per-warp moment sums (B1 with corr only)
__host__ __device__ inline int bank_rows(bool rds) { return rds ? 3 : 2; }

__host__ __device__ inline int u_len(const Geometry& g) {
  const int win = g.k_rf ? 2 * g.decim * g.lp : 0;
  return win > g.l_fm ? win : g.l_fm;
}

__host__ __device__ inline size_t smem_floats(const Geometry& g, bool rds,
                                              bool corr) {
  return static_cast<size_t>(g.k_rf ? g.decim * g.nq : 0) +
         (bank_rows(rds) + rds) * g.kp + 2 * static_cast<size_t>(g.l_iq) +
         u_len(g) + (corr ? kMoments * kWarps : 0);
}

// rf::Bufs: hs, win_i, win_q, iq_i, iq_q.
struct Smem : rf::Bufs {
  float* hb;
  float* hc;
  float* fm;
  float* rb;   // the RDS band, over iq_i
  float* sq;   // [carrier_tail || squared RDS band], over iq_q
  float* red;
};

__device__ Smem carve(float* smem, const Geometry& g, bool rds) {
  Smem s;
  s.hs = smem;
  s.hb = s.hs + (g.k_rf ? g.decim * g.nq : 0);
  s.hc = s.hb + bank_rows(rds) * g.kp;
  s.iq_i = s.hc + (rds ? g.kp : 0);
  s.iq_q = s.iq_i + g.l_iq;
  s.win_i = s.iq_q + g.l_iq;
  s.win_q = s.win_i + g.decim * g.lp;
  s.fm = s.win_i;
  s.rb = s.iq_i;
  s.sq = s.iq_q;
  s.red = s.win_i + u_len(g);
  return s;
}

// One tile's ranges, in global sample indices of the row.  The tile owns
// outputs [m0, m1); the bank makes [b0, m1) (with RDS the RDS band's kb-1
// samples before m0, for the carrier); fm_ext[l] holds fm at f_base + l
// and iq[l] the I/Q at q_base + l.  The RF stage (or B6's load) fills the
// I/Q from global g0: q_base, or 0 in tile 0, whose slot s_b holds the
// carried prev_i/prev_q and whose fm history is bank_tail.
struct Tile {
  int m0, m1, b0, n_bank, f_base, q_base, g0, l0, lf0;
  bool first, last;
};

__device__ Tile make_tile(const Geometry& g, int tile, bool rds) {
  Tile t;
  t.first = tile == 0;
  t.last = tile == g.n_tiles - 1;
  t.m0 = tile * g.tile;
  t.m1 = min(t.m0 + g.tile, g.n_out);
  t.b0 = t.first ? 0 : t.m0 - (rds ? g.s_b : 0);
  t.n_bank = t.m1 - t.b0;
  t.f_base = t.b0 - g.s_b;
  t.q_base = t.f_base - 1;
  t.g0 = t.first ? 0 : t.q_base;
  t.l0 = t.g0 - t.q_base;
  t.lf0 = t.first ? g.s_b : 0;
  return t;
}

// Per-row pointers of everything stages 2-4 read and write.
struct BandIO {
  const float* prev_i;  const float* prev_q;
  const float* bank_tail;  const float* mono_delay;
  const float* carrier_tail;  const float* rds_delay;
  float* fmd;  float* pilot;  float* stereo;  float* carrier;  float* rdsdel;
  float* prev_i_out;  float* prev_q_out;
  float* bank_tail_out;  float* mono_delay_out;
  float* carrier_tail_out;  float* rds_delay_out;
};

__device__ inline void load_taps(const Smem& s, const Geometry& g,
                                 const float* h_bank, const float* h_carrier,
                                 int nb, int tid) {
  for (int j = tid; j < nb * g.kp; j += kThreads) {
    const int f = j / g.kp, a = j % g.kp;
    s.hb[j] = a < g.kb ? h_bank[f * g.kb + g.s_b - a] : 0.0f;
  }
  if (h_carrier)
    for (int a = tid; a < g.kp; a += kThreads)
      s.hc[a] = a < g.kb ? h_carrier[g.s_b - a] : 0.0f;
}

// The corr epilogue of one tile.  On entry iq_i/iq_q hold the tile's
// decimated I/Q, visible to every thread.  Writes the tile's moment sums
// over [m0, m1) to partial[row, tile] (thread t sums the tile's samples
// g0 + t + kThreads*k that are its own outputs); the row's last tile to
// get here sums the row's partials in tile order into mom[row] / n_out.
// Leaves the corrected I/Q in place, visible to every thread.
__device__ void corr_stage(const Smem& s, const Geometry& g, const Tile& t,
                           long long row, int tile, int tid,
                           const float* corr, float* mom, float* partial,
                           int* count) {
  __shared__ int last;
  const float dci = corr[row * 4], dcq = corr[row * 4 + 1];
  const float rho = corr[row * 4 + 2], sc = corr[row * 4 + 3];
  float acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.0f;
  // each thread reads, sums (its own outputs only) and corrects its
  // samples, so no other thread sees one before its correction
  for (int l = t.l0 + tid; l < t.m1 - t.q_base; l += kThreads) {
    const float im = s.iq_i[l];
    const float qm = s.iq_q[l];
    if (l + t.q_base >= t.m0) {
      const float i2 = im * im, q2 = qm * qm;
      const float i3 = i2 * im, q3 = q2 * qm;
      // _POWERS: (4,0) (3,1) (2,2) (1,3) (0,4) (3,0) (2,1) (1,2) (0,3)
      //          (2,0) (1,1) (0,2) (1,0) (0,1)
      acc[0] += i2 * i2;  acc[1] += i3 * qm;  acc[2] += i2 * q2;
      acc[3] += im * q3;  acc[4] += q2 * q2;  acc[5] += i3;
      acc[6] += i2 * qm;  acc[7] += im * q2;  acc[8] += q3;
      acc[9] += i2;       acc[10] += im * qm; acc[11] += q2;
      acc[12] += im;      acc[13] += qm;
    }
    const float ic = im - dci;
    s.iq_i[l] = ic;
    s.iq_q[l] = (qm - dcq - rho * ic) * sc;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kMoments; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s.red[k * kWarps + warp] = v;
  }
  __syncthreads();  // the per-warp sums and the corrected I/Q
  float* mine = partial + (row * g.n_tiles + tile) * kMoments;
  if (tid < kMoments) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += s.red[tid * kWarps + w];
    mine[tid] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + row, 1) == g.n_tiles - 1;
  __syncthreads();
  if (last && tid < kMoments) {
    __threadfence();
    const float* all = partial + row * g.n_tiles * kMoments;
    float v = 0.0f;
    for (int k = 0; k < g.n_tiles; ++k) v += __ldcg(all + k * kMoments + tid);
    mom[row * kMoments + tid] = v / static_cast<float>(g.n_out);
  }
}

// Stages 2-4 of one tile.  On entry iq_i/iq_q hold the tile's I/Q from
// l0 on (and tile 0's carried prev at s_b), visible to every thread, and
// the bank (and carrier) taps are in shared memory.  kBf16: the bank's fm
// and the carrier BPF's squared band rounded to bf16 (the note above).
template <bool kRds, bool kBf16>
__device__ void band_stages(const Smem& s, const Geometry& g, const Tile& t,
                            long long row, int tid, const BandIO& io) {
  constexpr int kNb = kRds ? 3 : 2;
  const long long ro = row * g.n_out;
  float* fm = s.fm;

  // ---- 2. demod into fm_ext = [bank_tail || fm] (tile 0) or fm
  if (t.first)
    for (int k = tid; k < g.s_b; k += kThreads)
      fm[k] = io.bank_tail[row * g.s_b + k];
  const int n_fm = t.n_bank + g.s_b;
  for (int l = t.lf0 + tid; l < n_fm; l += kThreads)
    fm[l] = rf::fm_demod(s.iq_i[l + 1], s.iq_q[l + 1], s.iq_i[l], s.iq_q[l]);
  for (int l = n_fm + tid; l < g.l_fm; l += kThreads) fm[l] = 0.0f;
  if (t.last && tid == 0) {
    io.prev_i_out[row] = s.iq_i[g.n_out - 1 - t.q_base];
    io.prev_q_out[row] = s.iq_q[g.n_out - 1 - t.q_base];
  }
  __syncthreads();  // i / q are dead from here on

  // ---- 3. mono delay and the fm tails, from the float32 fm; then the
  // band bank over fm (kBf16: over fm rounded in place, once those reads
  // are done).  With RDS the RDS band goes to rb and its square to sq =
  // [carrier_tail || sq] (tile 0) or sq, rounded on kBf16
  for (int m = t.m0 + tid; m < t.m1; m += kThreads)
    io.fmd[ro + m] = t.first && m < g.dly ? io.mono_delay[row * g.dly + m]
                                          : fm[m - g.dly - t.f_base];
  if (t.last) {
    for (int k = tid; k < g.s_b; k += kThreads)
      io.bank_tail_out[row * g.s_b + k] = fm[g.n_out - g.s_b + k - t.f_base];
    for (int d = tid; d < g.dly; d += kThreads)
      io.mono_delay_out[row * g.dly + d] =
          fm[g.n_out - g.dly + d - t.f_base];
  }
  if (kBf16) {
    __syncthreads();
    for (int l = tid; l < n_fm; l += kThreads) fm[l] = rf::bf16(fm[l]);
    __syncthreads();
  }
  const int sq_off = t.first ? g.s_b : 0;
  if (kRds && t.first)
    for (int k = tid; k < g.s_b; k += kThreads) {
      const float v = io.carrier_tail[row * g.s_b + k];
      s.sq[k] = kBf16 ? rf::bf16(v) : v;
    }
  for (int c = tid; c < round4(t.n_bank) / kR; c += kThreads) {
    const int t0 = c * kR;
    float acc[kNb][kR] = {};
    mac4<kNb>(s.hb, g.kp, fm + t0, g.kp / 4, acc);
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int tt = t0 + k;
      if (tt < t.n_bank) {
        const int m = t.b0 + tt;
        if (m >= t.m0) {
          io.pilot[ro + m] = acc[0][k];
          io.stereo[ro + m] = acc[1][k];
        }
        if (kRds) {
          const float v = acc[kNb - 1][k] * acc[kNb - 1][k];
          s.rb[tt] = acc[kNb - 1][k];
          s.sq[tt + sq_off] = kBf16 ? rf::bf16(v) : v;
        }
      }
    }
  }
  if (!kRds) return;
  const int n_c = t.m1 - t.m0;
  for (int k = n_c + g.s_b + tid; k < round4(n_c) + g.kp; k += kThreads)
    s.sq[k] = 0.0f;
  __syncthreads();

  // ---- 4. carrier BPF over the squared RDS band, RDS delay
  for (int c = tid; c < round4(n_c) / kR; c += kThreads) {
    const int t0 = c * kR;
    float acc[1][kR] = {};
    mac4<1>(s.hc, 0, s.sq + t0, g.kp / 4, acc);
#pragma unroll
    for (int k = 0; k < kR; ++k)
      if (t0 + k < n_c) io.carrier[ro + t.m0 + t0 + k] = acc[0][k];
  }
  for (int m = t.m0 + tid; m < t.m1; m += kThreads)
    io.rdsdel[ro + m] = t.first && m < g.dly ? io.rds_delay[row * g.dly + m]
                                             : s.rb[m - g.dly - t.b0];
  if (t.last) {
    // the float32 square of the row's last s_b RDS-band samples
    for (int k = tid; k < g.s_b; k += kThreads) {
      const float v = s.rb[g.n_out - g.s_b + k - t.b0];
      io.carrier_tail_out[row * g.s_b + k] = v * v;
    }
    for (int d = tid; d < g.dly; d += kThreads)
      io.rds_delay_out[row * g.dly + d] = s.rb[g.n_out - g.dly + d - t.b0];
  }
}

template <bool kRds, bool kCorr, bool kBf16>
__global__ void __launch_bounds__(kThreads, kFullBlocks)
    frontend_full_kernel(
    const uint8_t* __restrict__ iq_u8, const float* __restrict__ h_rf,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    const float* __restrict__ iq_tail, float* __restrict__ iq_tail_out,
    const float* __restrict__ corr, float* __restrict__ mom,
    float* __restrict__ partial, int* __restrict__ count, BandIO io,
    Geometry g) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, kRds);
  const long long row = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const Tile t = make_tile(g, tile, kRds);
  const uint8_t* x = iq_u8 + row * g.bs;
  const float* tail = iq_tail + row * 2 * g.s_rf;  // [2, s_rf]

  rf::load_taps(s.hs, g, h_rf, tid);
  load_taps(s, g, h_bank, kRds ? h_carrier : nullptr, bank_rows(kRds), tid);
  if (t.first && tid == 0) {
    s.iq_i[g.s_b] = io.prev_i[row];
    s.iq_q[g.s_b] = io.prev_q[row];
  }
  rf::rf_stage<false, false>(s, g, t.g0, t.m1, t.l0,
                      rf::Pairs{reinterpret_cast<const uint16_t*>(x)}, tail,
                      tid);
  if (t.last)
    for (int j = tid; j < 2 * g.s_rf; j += kThreads) {
      // next RF tail, [2, s_rf], from the raw block's last 2*s_rf bytes
      const int leg = j / g.s_rf;
      const int k = j % g.s_rf;
      iq_tail_out[row * 2 * g.s_rf + j] =
          norm(x[g.bs - 2 * g.s_rf + 2 * k + leg]);
    }
  if (kCorr) corr_stage(s, g, t, row, tile, tid, corr, mom, partial, count);
  band_stages<kRds, kBf16>(s, g, t, row, tid, io);
}

template <bool kRds, bool kBf16>
__global__ void __launch_bounds__(kThreads) frontend_if_kernel(
    const float* __restrict__ i_if, const float* __restrict__ q_if,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    BandIO io, Geometry g) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), g, kRds);
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const Tile t = make_tile(g, blockIdx.y, kRds);
  const long long ro = row * g.n_out;

  load_taps(s, g, h_bank, kRds ? h_carrier : nullptr, bank_rows(kRds), tid);
  if (t.first && tid == 0) {
    s.iq_i[g.s_b] = io.prev_i[row];
    s.iq_q[g.s_b] = io.prev_q[row];
  }
  // ---- 1. the tile's IF I/Q [g0, m1) into iq_i / iq_q
  for (int m = t.g0 + tid; m < t.m1; m += kThreads) {
    s.iq_i[m - t.q_base] = i_if[ro + m];
    s.iq_q[m - t.q_base] = q_if[ro + m];
  }
  __syncthreads();
  band_stages<kRds, kBf16>(s, g, t, row, tid, io);
}

template <bool kRds, bool kCorr, bool kBf16>
int launch_full(const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
                const float* h_carrier, const float* iq_tail,
                float* iq_tail_out, const float* corr, float* mom,
                float* partial, int* count, const BandIO& io,
                const Geometry& g, long long c, cudaStream_t stream) {
  if (!plan_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(g, kRds, kCorr) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      frontend_full_kernel<kRds, kCorr, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kCorr) {
    err = cudaMemsetAsync(count, 0, static_cast<size_t>(c) * sizeof(int),
                          stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(c), static_cast<unsigned>(g.n_tiles));
  frontend_full_kernel<kRds, kCorr, kBf16><<<grid, kThreads, smem, stream>>>(
      iq_u8, h_rf, h_bank, h_carrier, iq_tail, iq_tail_out, corr, mom,
      partial, count, io, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRds, bool kBf16>
int launch_if(const float* i_if, const float* q_if, const float* h_bank,
              const float* h_carrier, const BandIO& io, const Geometry& g,
              long long c, cudaStream_t stream) {
  if (!plan_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(g, kRds, false) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      frontend_if_kernel<kRds, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(c), static_cast<unsigned>(g.n_tiles));
  frontend_if_kernel<kRds, kBf16><<<grid, kThreads, smem, stream>>>(
      i_if, q_if, h_bank, h_carrier, io, g);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of launch_full for rds and bf16.
template <bool kCorr>
int launch_full_for(bool rds, bool bf16, const uint8_t* iq_u8,
                    const float* h_rf, const float* h_bank,
                    const float* h_carrier, const float* iq_tail,
                    float* iq_tail_out, const float* corr, float* mom,
                    float* partial, int* count, const BandIO& io,
                    const Geometry& g, long long c, cudaStream_t st) {
  auto launch = rds ? (bf16 ? launch_full<true, kCorr, true>
                            : launch_full<true, kCorr, false>)
                    : (bf16 ? launch_full<false, kCorr, true>
                            : launch_full<false, kCorr, false>);
  return launch(iq_u8, h_rf, h_bank, h_carrier, iq_tail, iq_tail_out, corr,
                mom, partial, count, io, g, c, st);
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes: B1 for tiles of
// `tile` outputs and RF passes of `sub` outputs at decimation `decim`
// through k_rf RF taps (with the corr epilogue when corr != 0), or B6
// (k_rf = 0, decim = 1, sub = 0, corr = 0).  frontend_cuda._smem_bytes
// computes the same; the wrappers check it against the card's 227 KB
// before a launch.
extern "C" long long dy4_frontend_smem(int tile, int sub, int decim,
                                       int k_rf, int kb, int rds, int corr) {
  const Geometry g = make_geometry(2LL * decim * tile, decim, k_rf, kb,
                                   rds != 0, tile, sub);
  return static_cast<long long>(smem_floats(g, rds != 0, corr != 0) *
                                sizeof(float));
}

// B1.  Shapes (all row-major, float32 unless said): iq_u8 [c, bs] u8,
// h_rf [k_rf], h_bank [nb, kb] (nb >= 3 with rds, >= 2 without; only the
// first rows are read), h_carrier [kb], iq_tail [c, 2, k_rf-1],
// prev_i/prev_q [c], bank_tail [c, kb-1], mono_delay [c, kb/2],
// carrier_tail [c, kb-1], rds_delay [c, kb/2]; the five outputs
// [c, bs/2/decim] and the new tails in the shapes of the old ones.  With
// rds = 0, h_carrier, carrier_tail, rds_delay, carrier, rdsdel and their
// new tails are not touched and may be null.  bf16 != 0: the band stage
// rounds its streams to bf16 (the note at the top; the taps come rounded).
// tile, sub: the plan (frontend_cuda._tile_plan).  Returns
// cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int dy4_frontend_full(
    const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
    const float* h_carrier, const float* iq_tail, const float* prev_i,
    const float* prev_q, const float* bank_tail, const float* mono_delay,
    const float* carrier_tail, const float* rds_delay, float* fmd,
    float* pilot, float* stereo, float* carrier, float* rdsdel,
    float* iq_tail_out, float* prev_i_out, float* prev_q_out,
    float* bank_tail_out, float* mono_delay_out, float* carrier_tail_out,
    float* rds_delay_out, long long c, long long bs, int decim, int k_rf,
    int kb, int rds, int bf16, int tile, int sub, void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(bs, decim, k_rf, kb, rds != 0, tile, sub);
  const BandIO io{prev_i, prev_q, bank_tail, mono_delay, carrier_tail,
                  rds_delay, fmd, pilot, stereo, carrier, rdsdel,
                  prev_i_out, prev_q_out, bank_tail_out, mono_delay_out,
                  carrier_tail_out, rds_delay_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_full_for<false>(rds != 0, bf16 != 0, iq_u8, h_rf, h_bank,
                                h_carrier, iq_tail, iq_tail_out, nullptr,
                                nullptr, nullptr, nullptr, io, g, c, st);
}

// B1 with the corr epilogue: the arguments of dy4_frontend_full, then
// corr [c, 4] (dc_i, dc_q, rho, s per row), mom [c, 14] (out), and the
// scratch partial [c, n_tiles, 14] float32 and count [c] int32 (zeroed
// here on the stream before the launch).
extern "C" int dy4_frontend_full_corr(
    const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
    const float* h_carrier, const float* iq_tail, const float* prev_i,
    const float* prev_q, const float* bank_tail, const float* mono_delay,
    const float* carrier_tail, const float* rds_delay, float* fmd,
    float* pilot, float* stereo, float* carrier, float* rdsdel,
    float* iq_tail_out, float* prev_i_out, float* prev_q_out,
    float* bank_tail_out, float* mono_delay_out, float* carrier_tail_out,
    float* rds_delay_out, const float* corr, float* mom, float* partial,
    int* count, long long c, long long bs, int decim, int k_rf, int kb,
    int rds, int bf16, int tile, int sub, void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(bs, decim, k_rf, kb, rds != 0, tile, sub);
  const BandIO io{prev_i, prev_q, bank_tail, mono_delay, carrier_tail,
                  rds_delay, fmd, pilot, stereo, carrier, rdsdel,
                  prev_i_out, prev_q_out, bank_tail_out, mono_delay_out,
                  carrier_tail_out, rds_delay_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_full_for<true>(rds != 0, bf16 != 0, iq_u8, h_rf, h_bank,
                               h_carrier, iq_tail, iq_tail_out, corr, mom,
                               partial, count, io, g, c, st);
}

// B6.  i_if, q_if: [c, n_out] float32; the rest as for B1 without the RF
// taps and tail (the IF entry carries the RF tail through untouched).
extern "C" int dy4_frontend_if(
    const float* i_if, const float* q_if, const float* h_bank,
    const float* h_carrier, const float* prev_i, const float* prev_q,
    const float* bank_tail, const float* mono_delay,
    const float* carrier_tail, const float* rds_delay, float* fmd,
    float* pilot, float* stereo, float* carrier, float* rdsdel,
    float* prev_i_out, float* prev_q_out, float* bank_tail_out,
    float* mono_delay_out, float* carrier_tail_out, float* rds_delay_out,
    long long c, int n_out, int kb, int rds, int bf16, int tile,
    void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(2LL * n_out, 1, 0, kb, rds != 0, tile, 0);
  const BandIO io{prev_i, prev_q, bank_tail, mono_delay, carrier_tail,
                  rds_delay, fmd, pilot, stereo, carrier, rdsdel,
                  prev_i_out, prev_q_out, bank_tail_out, mono_delay_out,
                  carrier_tail_out, rds_delay_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = rds ? (bf16 ? launch_if<true, true> : launch_if<true, false>)
                    : (bf16 ? launch_if<false, true>
                            : launch_if<false, false>);
  return launch(i_if, q_if, h_bank, h_carrier, io, g, c, st);
}
