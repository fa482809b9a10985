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
// stages 2-4 are the same device routine (band_stages, band_stages_tc).  Both
// kernels are templated on RDS: without it the bank has two rows, stage 4
// is skipped, and neither the carrier taps nor the RDS tails and outputs
// are touched (their pointers may be null).  And on kBf16, dy4tpu's
// mm_dtype=bf16 (precision "default" / "high", ops/precision.py), the
// three filters run on the tensor cores (the second design below): the RF
// LPF on the u8 window (exact in bf16), the bank on fm rounded to bf16
// and the carrier BPF on the squared RDS band rounded to bf16, as
// dy4tpu's _kernel_front_full and _band_stages cast them before their
// dots, the taps rounded to bf16 as the kernel builds its B fragments (the
// wrapper passes them as they are).  The mono and RDS delays and every
// carried tail stay float32.
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
//
// The second design, kBf16 (precision "default" / "high"): dy4tpu's bf16
// MXU dots as bf16 mma.sync Toeplitz products (mma_bf16.cuh) with float32
// sums.  The operands are exact in bf16, so the bytes bound it (the u8
// read at mode 0 is 153,600 bytes a row; the tensor cores' bound is a
// tenth of it).  The same (row, tile) grid; what changes:
//
//  * RF stage: a warp makes 128 outputs of one leg an MMA k-step at a
//    time (rows of 8 outputs, k-steps of 16 window samples: 11 at D = 10,
//    9 at D = 5), A straight from the raw u8 words (rf_words: a lane's
//    4 samples of a row in one 8-byte load, each 32-bit word an I pair and
//    a Q pair, (b - 128) exact in bf16), B the Toeplitz fragments of h /
//    128 (exact: a power of two) with the k order to match
//    (toeplitz_frag's kQuad), built once a block in shared memory while
//    the first window is copied.  The window of a pass of `sub` outputs (4
//    MMA units, one per warp and leg) is copied into a ring of two u8
//    buffers by 4-byte cp.async copies straight into place, the next
//    pass's while this one multiplies; a window whose first word is not
//    4-byte aligned in device memory is staged from the sample before it
//    and read through a funnel shift.  Samples of the carried RF tail
//    are staged as zeros: the few outputs that reach into it (rf_stage_tc)
//    add its float32 products, summed on the CUDA cores.
//  * Band stage: the demod writes fm once, in float32 to the mono delay
//    and the fm tails, rounded to bf16 into shared memory; the bank (2 or
//    3 filters sharing each A fragment, 7 k-steps) and the carrier BPF
//    (over the bf16 squared band) take their A fragments by ldmatrix.
//  * Every MMA row starts at a multiple of 8 outputs of the row (the RF
//    stage starts at g0 rounded down to 8, a tile's bank at b0 rounded
//    down to 8, which widens the halo by up to 7), so an output's
//    k-steps hold the same samples in every tile and under every plan:
//    a recomputed halo sample is still its own tile's, bit for bit.
//  * About 44 KB of shared memory a B1 block at mode 0 (29 KB at mode
//    1), registers capped for 4 blocks an SM (kTcBlocks).
//
// Numerics of kBf16: the products are exact and the sums float32 in the
// tensor cores' order, so B1's I/Q differ from a float32 filter on the
// same rounded operands by float32 rounding; the demod and everything
// after it round as above.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
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
constexpr int kTcBlocks = 4;    // kBf16 blocks an SM: 64 registers a thread
constexpr int kMoments = 14;  // IQ-tracker moments (corr epilogue)

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int round_units(int n) {
  return (n + tc::kUnit - 1) / tc::kUnit * tc::kUnit;
}

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
  // kBf16 (the tensor-core design; sub is then outputs an RF pass, a
  // multiple of 128)
  int ks_rf;       // k-steps of the RF product (B1)
  int ks_b;        // k-steps of the band and carrier products
  int win_bytes;   // bytes of one buffer of the RF ring: a pass's u8 window
  int l_fmb;       // bf16 of the bank's input, fm_ext
  int l_sq;        // bf16 of the carrier BPF's input, sq
  int l_q;         // floats of the second I/Q buffer (which holds sq)
};

// bf16: the tensor-core design's geometry, whose tiles' banks start at
// multiples of 8 (the halo up to 7 samples wider with RDS).
Geometry make_geometry(long long bs, int decim, int k_rf, int kb, bool rds,
                       int tile, int sub, bool bf16 = false) {
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
  const int shift = rds ? (bf16 ? round8(g.s_b) : g.s_b) : 0;  // m0 - b0
  g.halo = shift + kb;
  g.sub = k_rf ? sub : 0;
  g.nq = k_rf ? round4(g.s_rf / decim + 1) : 0;
  g.lp = k_rf ? window_row(sub + g.nq) : 0;
  g.kp = round4(kb);
  g.l_iq = round4(tile + g.halo);
  g.l_fm = round4(tile + (rds ? g.s_b : 0)) + g.kp + 4;
  g.ks_rf = k_rf ? tc::ksteps(decim, k_rf) : 0;
  g.ks_b = tc::ksteps(1, kb);
  // a pass reads its window up to row 15 of its last unit, k-step ks_rf
  // - 1; the ring stages it in words from up to one sample before
  const int win = k_rf ? (sub - 8) * decim + tc::kK * g.ks_rf : 0;
  g.win_bytes = (2 * win + 4 + 15) & ~15;
  g.l_fmb = round8(round_units(tile + shift) - 8 + tc::kK * g.ks_b);
  g.l_sq = round8(round_units(tile) - 8 + tc::kK * g.ks_b);
  g.l_q = g.l_iq > round4((g.l_sq + 1) / 2) ? g.l_iq
                                             : round4((g.l_sq + 1) / 2);
  return g;
}

bool plan_ok(const Geometry& g) {
  return g.tile >= g.halo && g.tile % 4 == 0 &&
         (!g.k_rf || (g.sub >= kR && g.sub % kR == 0 &&
                      g.decim * (g.sub + g.nq) <= kRound));
}

// The tensor-core design's plans: tiles of whole rows of 8 outputs, RF
// passes of whole MMA units.
bool plan_ok_tc(const Geometry& g) {
  return g.tile >= g.halo && g.tile % 8 == 0 &&
         (!g.k_rf || (g.sub >= tc::kUnit && g.sub % tc::kUnit == 0));
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

// The tensor-core design's shared memory, in bytes, in this order (each a
// multiple of 16):
//   fr [ks_rf, 32] uint2      the RF product's B fragments, by lane (B1)
//   fb [nb, ks_b, 32] uint2   the bank's
//   fc [ks_b, 32] uint2       the carrier BPF's (RDS only)
//   iq_i [l_iq], iq_q [l_q]   the tile's I/Q (float32); then the RDS band
//                             (float32) and [carrier_tail || squared RDS
//                             band] (bf16)
//   u                         the RF ring, two buffers of win_bytes (B1);
//                             then fm_ext [bank_tail || fm] (bf16)
//   red [kMoments, kWarps]    per-warp moment sums (B1 with corr only)
__host__ __device__ inline size_t u_bytes_tc(const Geometry& g) {
  const size_t ring = g.k_rf ? 2 * static_cast<size_t>(g.win_bytes) : 0;
  const size_t fm = static_cast<size_t>(g.l_fmb) * 2;
  return ring > fm ? ring : fm;
}

__host__ __device__ inline size_t smem_bytes_tc(const Geometry& g, bool rds,
                                                bool corr) {
  const size_t frag = 32 * sizeof(uint2);
  return frag * (g.ks_rf + (bank_rows(rds) + rds) * g.ks_b) +
         4 * (static_cast<size_t>(g.l_iq) + g.l_q) + u_bytes_tc(g) +
         (corr ? 4 * kMoments * kWarps : 0);
}

struct TcSmem {
  uint2* fr;
  uint2* fb;
  uint2* fc;
  float* iq_i;
  float* iq_q;
  unsigned* ring;   // the RF ring, u8 I/Q words
  uint16_t* fm;     // over the ring
  float* rb;        // the RDS band, over iq_i
  uint16_t* sq;     // over iq_q
  float* red;
};

__device__ TcSmem carve_tc(unsigned char* smem, const Geometry& g,
                           bool rds) {
  TcSmem s;
  s.fr = reinterpret_cast<uint2*>(smem);
  s.fb = s.fr + 32 * g.ks_rf;
  s.fc = s.fb + 32 * bank_rows(rds) * g.ks_b;
  s.iq_i = reinterpret_cast<float*>(s.fc + (rds ? 32 * g.ks_b : 0));
  s.iq_q = s.iq_i + g.l_iq;
  s.ring = reinterpret_cast<unsigned*>(s.iq_q + g.l_q);
  s.fm = reinterpret_cast<uint16_t*>(s.ring);
  s.rb = s.iq_i;
  s.sq = reinterpret_cast<uint16_t*>(s.iq_q);
  s.red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.ring) +
                                   u_bytes_tc(g));
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

// bf16: the bank starts at a multiple of 8 (the tensor-core design).
__device__ Tile make_tile(const Geometry& g, int tile, bool rds,
                          bool bf16 = false) {
  Tile t;
  t.first = tile == 0;
  t.last = tile == g.n_tiles - 1;
  t.m0 = tile * g.tile;
  t.m1 = min(t.m0 + g.tile, g.n_out);
  t.b0 = t.first ? 0 : t.m0 - (rds ? g.s_b : 0);
  if (bf16) t.b0 &= ~7;
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
// Leaves the corrected I/Q in place, visible to every thread.  S: Smem or
// TcSmem (iq_i, iq_q, red).
template <class S>
__device__ void corr_stage(const S& s, const Geometry& g, const Tile& t,
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
// the bank (and carrier) taps are in shared memory.
template <bool kRds>
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

  // ---- 3. mono delay and the fm tails; the band bank over fm.  With RDS
  // the RDS band goes to rb and its square to sq = [carrier_tail || sq]
  // (tile 0) or sq
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
  const int sq_off = t.first ? g.s_b : 0;
  if (kRds && t.first)
    for (int k = tid; k < g.s_b; k += kThreads)
      s.sq[k] = io.carrier_tail[row * g.s_b + k];
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
          s.rb[tt] = acc[kNb - 1][k];
          s.sq[tt + sq_off] = acc[kNb - 1][k] * acc[kNb - 1][k];
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

// ---- the tensor-core design (kBf16) ----

// The A-fragment words of window samples s..s+3 (s a multiple of 4,
// counted from the pass's window start): at phase 0 the staged words s / 2
// and s / 2 + 1, one 8-byte load; at phase 1 (the window staged from the
// sample before it) each the high half of a word and the low half of the
// next.
template <bool kOdd>
__device__ __forceinline__ uint2 rf_words(const unsigned* buf, int s) {
  if (!kOdd) return *reinterpret_cast<const uint2*>(buf + (s >> 1));
  const unsigned w0 = buf[s >> 1], w1 = buf[(s >> 1) + 1],
                 w2 = buf[(s >> 1) + 2];
  return make_uint2(__funnelshift_r(w0, w1, 16), __funnelshift_r(w1, w2, 16));
}

// The B fragments of every product into shared memory: the RF product's
// (B1: h_rf reversed, times 1/128), the bank's (h_bank's rows reversed)
// and the carrier BPF's (h_carrier reversed).  Taps rounded to bf16.
template <bool kRds>
__device__ inline void load_frags(const TcSmem& s, const Geometry& g,
                                  const float* h_rf, const float* h_bank,
                                  const float* h_carrier, int tid) {
  constexpr int kNb = kRds ? 3 : 2;
  if (h_rf)
    for (int i = tid; i < 32 * g.ks_rf; i += kThreads)
      s.fr[i] = tc::toeplitz_frag<true>(
          [&](int a) { return h_rf[g.s_rf - a] * rf::kScale; }, g.k_rf,
          g.decim, i >> 5, i & 31);
  for (int i = tid; i < 32 * kNb * g.ks_b; i += kThreads) {
    const float* h = h_bank + (i / (32 * g.ks_b)) * g.kb;
    const int j = i % (32 * g.ks_b);
    s.fb[i] = tc::toeplitz_frag([&](int a) { return h[g.s_b - a]; }, g.kb,
                                1, j >> 5, j & 31);
  }
  if (kRds)
    for (int i = tid; i < 32 * g.ks_b; i += kThreads)
      s.fc[i] = tc::toeplitz_frag(
          [&](int a) { return h_carrier[g.s_b - a]; }, g.kb, 1, i >> 5,
          i & 31);
}

// The u8 window of one RF pass into `buf`: ext samples [e0, e0 + n_samp)
// (block sample e - s_rf), as 32-bit words of two samples each, by 4-byte
// cp.async copies, from the sample at or one before e0 - s_rf whose bytes
// are 4-byte aligned in device memory; samples outside the block (the RF
// tail, past the row's end) as 0x8080, i.e. 0.  Commits one copy group.
// Returns the phase: 1 where the window starts one sample into `buf`.
__device__ inline int stage_rf(unsigned* buf, const uint8_t* x,
                               const Geometry& g, long long e0, int n_samp,
                               int tid) {
  const long long n0 = e0 - g.s_rf;
  const int phase = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(x) + 2 * n0) >> 1) & 1);
  const long long ns = n0 - phase;
  const int n_words = (phase + n_samp + 1) >> 1;
  const uint16_t* x16 = reinterpret_cast<const uint16_t*>(x);
  for (int j = tid; j < n_words; j += kThreads) {
    const long long n = ns + 2 * j;
    if (n >= 0 && n + 1 < g.n_in) {
      cpa::copy4(buf + j, x + 2 * n);
    } else {
      const unsigned lo = n >= 0 && n < g.n_in ? x16[n] : 0x8080u;
      const unsigned hi = n + 1 >= 0 && n + 1 < g.n_in ? x16[n + 1] : 0x8080u;
      buf[j] = lo | hi << 16;
    }
  }
  cpa::commit();
  return phase;
}

// One pass's MMAs: `units` units of 128 RF outputs from p0 (a multiple of
// 8), each by two warps (leg = item & 1), over the window in `buf`, the k
// pairs of a lane standing for 4 adjacent samples (toeplitz_frag's kQuad:
// one 8-byte load a row and k-step); the outputs in [g0, m1) into iq_i /
// iq_q, plus the tail sums already there for outputs below n_tail.
template <bool kOdd>
__device__ inline void rf_pass_tc(const TcSmem& s, const unsigned* buf,
                                  const Geometry& g, const Tile& t, int p0,
                                  int units, int n_tail, int tid) {
  const int lane = tid & 31, gr = lane >> 2, t4 = lane & 3;
  for (int item = tid >> 5; item < 2 * units; item += kWarps) {
    const int u = item >> 1, leg = item & 1;
    const int r0 = (u * tc::kUnit + tc::kN * gr) * g.decim + 4 * t4;
    const int r1 = r0 + tc::kN * 8 * g.decim;      // row gr + 8
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < g.ks_rf; ++kk) {
      const uint2 w0 = rf_words<kOdd>(buf, r0 + tc::kK * kk);
      const uint2 w1 = rf_words<kOdd>(buf, r1 + tc::kK * kk);
      const unsigned a[4] = {
          tc::u8_leg_pair(w0.x, leg), tc::u8_leg_pair(w1.x, leg),
          tc::u8_leg_pair(w0.y, leg), tc::u8_leg_pair(w1.y, leg)};
      tc::mma(acc, a, s.fr[32 * kk + lane]);
    }
    float* out = leg ? s.iq_q : s.iq_i;
    const int m = p0 + u * tc::kUnit + tc::kN * gr + 2 * t4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mi = m + (i >> 1) * tc::kN * 8 + (i & 1);
      if (mi >= t.g0 && mi < t.m1) {
        const int l = mi - t.q_base;
        out[l] = mi < n_tail ? acc[i] + out[l] : acc[i];
      }
    }
  }
}

// The RF stage of one tile on the tensor cores: outputs [g0, m1) of both
// legs into iq_i / iq_q from slot l0 on, from the MMA units from g0
// rounded down to 8, in passes of g.sub outputs through the ring.  The
// outputs whose window reaches into the RF tail (m*D < s_rf) first get the
// tail's float32 products, tap by tap.  `prologue` (the B fragments) runs
// while the first pass's window is copied; ends with every output visible
// to every thread.
template <class Prologue>
__device__ void rf_stage_tc(const TcSmem& s, const Geometry& g,
                            const Tile& t, const uint8_t* x,
                            const float* tail, const float* h_rf, int tid,
                            const Prologue& prologue) {
  const int g0a = t.g0 & ~7;
  const int n_units = (t.m1 - g0a + tc::kUnit - 1) / tc::kUnit;
  const int per = g.sub / tc::kUnit;
  const int passes = (n_units + per - 1) / per;
  const int n_tail = (g.s_rf + g.decim - 1) / g.decim;
  const int t1 = min(n_tail, t.m1);
  unsigned* ring[2] = {s.ring, s.ring + g.win_bytes / 4};
  auto units = [&](int p) { return min(per, n_units - p * per); };
  auto stage = [&](int p) {
    return stage_rf(ring[p & 1], x, g,
                    static_cast<long long>(g0a + p * g.sub) * g.decim,
                    (units(p) * tc::kUnit - 8) * g.decim + tc::kK * g.ks_rf,
                    tid);
  };
  const int phase = stage(0);      // the same in every pass of the tile
  prologue();
  for (int k = tid; k < 2 * (t1 - t.g0); k += kThreads) {
    const int leg = k / (t1 - t.g0);
    const int m = t.g0 + k % (t1 - t.g0);
    float acc = 0.0f;
    for (int e = m * g.decim; e < g.s_rf; ++e)
      acc = fmaf(rf::bf16(h_rf[g.s_rf - (e - m * g.decim)]),
                 tail[leg * g.s_rf + e], acc);
    (leg ? s.iq_q : s.iq_i)[m - t.q_base] = acc;
  }
  for (int p = 0; p < passes; ++p) {
    if (p + 1 < passes) {
      stage(p + 1);
      cpa::wait<1>();
    } else {
      cpa::wait<0>();
    }
    __syncthreads();  // pass p's window (first: the fragments, tail sums)
    if (phase)
      rf_pass_tc<true>(s, ring[p & 1], g, t, g0a + p * g.sub, units(p),
                       n_tail, tid);
    else
      rf_pass_tc<false>(s, ring[p & 1], g, t, g0a + p * g.sub, units(p),
                        n_tail, tid);
    __syncthreads();  // buffer p & 1 read before pass p + 2 refills it
  }
}

// Stages 2-4 of one tile on the tensor cores.  On entry iq_i/iq_q hold the
// tile's I/Q from l0 on (and tile 0's carried prev at s_b), visible to
// every thread, and the band B fragments are in shared memory.
template <bool kRds>
__device__ void band_stages_tc(const TcSmem& s, const Geometry& g,
                               const Tile& t, long long row, int tid,
                               const BandIO& io) {
  constexpr int kNb = kRds ? 3 : 2;
  const long long ro = row * g.n_out;
  const int lane = tid & 31, gr = lane >> 2, t4 = lane & 3;
  const int a_off = tc::ldsm_row(lane, tc::kN);   // rows 8 outputs apart

  // ---- 2. demod: fm in float32 to the mono delay and the fm tails, and
  // rounded to bf16 into fm_ext = [bank_tail || fm] (tile 0) or fm
  const int n_fm = t.n_bank + g.s_b;
  const int n_ub = (t.n_bank + tc::kUnit - 1) / tc::kUnit;
  if (t.first) {
    for (int k = tid; k < g.s_b; k += kThreads)
      s.fm[k] = tc::bf16_bits(io.bank_tail[row * g.s_b + k]);
    for (int m = tid; m < min(g.dly, t.m1); m += kThreads)
      io.fmd[ro + m] = io.mono_delay[row * g.dly + m];
  }
  for (int l = t.lf0 + tid; l < n_fm; l += kThreads) {
    const float v =
        rf::fm_demod(s.iq_i[l + 1], s.iq_q[l + 1], s.iq_i[l], s.iq_q[l]);
    s.fm[l] = tc::bf16_bits(v);
    const int p = t.f_base + l;       // fm sample p of the row
    if (p + g.dly >= t.m0 && p + g.dly < t.m1) io.fmd[ro + p + g.dly] = v;
    if (t.last && p >= g.n_out - g.s_b)
      io.bank_tail_out[row * g.s_b + p - (g.n_out - g.s_b)] = v;
    if (t.last && p >= g.n_out - g.dly)
      io.mono_delay_out[row * g.dly + p - (g.n_out - g.dly)] = v;
  }
  for (int l = n_fm + tid; l < n_ub * tc::kUnit - 8 + tc::kK * g.ks_b;
       l += kThreads)
    s.fm[l] = 0;
  if (t.last && tid == 0) {
    io.prev_i_out[row] = s.iq_i[g.n_out - 1 - t.q_base];
    io.prev_q_out[row] = s.iq_q[g.n_out - 1 - t.q_base];
  }
  __syncthreads();  // fm visible; i / q are dead from here on

  // ---- 3. the band bank over fm_ext.  With RDS the RDS band goes to rb
  // and its square, rounded, to sq: sq[i] holds the square at m0 - s_b +
  // i (tile 0: carrier_tail below it)
  const int n_c = t.m1 - t.m0;
  const int n_uc = (n_c + tc::kUnit - 1) / tc::kUnit;
  const int sq_off = g.s_b - (t.m0 - t.b0);
  if (kRds) {
    if (t.first)
      for (int k = tid; k < g.s_b; k += kThreads)
        s.sq[k] = tc::bf16_bits(io.carrier_tail[row * g.s_b + k]);
    for (int k = n_c + g.s_b + tid; k < n_uc * tc::kUnit - 8 + tc::kK * g.ks_b;
         k += kThreads)
      s.sq[k] = 0;
  }
  for (int u = tid >> 5; u < n_ub; u += kWarps) {
    float acc[kNb][4] = {};
    const uint16_t* a_row = s.fm + u * tc::kUnit + a_off;
    for (int kk = 0; kk < g.ks_b; ++kk) {
      unsigned a[4];
      tc::ldsm_x4(a, a_row + tc::kK * kk);
#pragma unroll
      for (int f = 0; f < kNb; ++f)
        tc::mma(acc[f], a, s.fb[32 * (f * g.ks_b + kk) + lane]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = u * tc::kUnit + tc::kN * (gr + 8 * (i >> 1)) + 2 * t4 +
                     (i & 1);
      if (tt < t.n_bank) {
        const int m = t.b0 + tt;
        if (m >= t.m0) {
          io.pilot[ro + m] = acc[0][i];
          io.stereo[ro + m] = acc[1][i];
        }
        if (kRds) {
          s.rb[tt] = acc[kNb - 1][i];
          if (tt + sq_off >= 0)
            s.sq[tt + sq_off] =
                tc::bf16_bits(acc[kNb - 1][i] * acc[kNb - 1][i]);
        }
      }
    }
  }
  if (!kRds) return;
  __syncthreads();

  // ---- 4. carrier BPF over the squared RDS band, RDS delay
  for (int u = tid >> 5; u < n_uc; u += kWarps) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const uint16_t* a_row = s.sq + u * tc::kUnit + a_off;
    for (int kk = 0; kk < g.ks_b; ++kk) {
      unsigned a[4];
      tc::ldsm_x4(a, a_row + tc::kK * kk);
      tc::mma(acc, a, s.fc[32 * kk + lane]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = u * tc::kUnit + tc::kN * (gr + 8 * (i >> 1)) + 2 * t4 +
                     (i & 1);
      if (tt < n_c) io.carrier[ro + t.m0 + tt] = acc[i];
    }
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

// B1 on the tensor cores (frontend_full_kernel at kBf16).
template <bool kRds, bool kCorr>
__device__ void frontend_full_tc(
    unsigned char* smem, const uint8_t* iq_u8, const float* h_rf,
    const float* h_bank, const float* h_carrier, const float* iq_tail,
    float* iq_tail_out, const float* corr, float* mom, float* partial,
    int* count, const BandIO& io, const Geometry& g) {
  const TcSmem s = carve_tc(smem, g, kRds);
  const long long row = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const Tile t = make_tile(g, tile, kRds, true);
  const uint8_t* x = iq_u8 + row * g.bs;
  const float* tail = iq_tail + row * 2 * g.s_rf;  // [2, s_rf]

  rf_stage_tc(s, g, t, x, tail, h_rf, tid, [&] {
    load_frags<kRds>(s, g, h_rf, h_bank, h_carrier, tid);
    if (t.first && tid == 0) {
      s.iq_i[g.s_b] = io.prev_i[row];
      s.iq_q[g.s_b] = io.prev_q[row];
    }
  });
  if (t.last)
    for (int j = tid; j < 2 * g.s_rf; j += kThreads) {
      const int leg = j / g.s_rf;
      const int k = j % g.s_rf;
      iq_tail_out[row * 2 * g.s_rf + j] =
          norm(x[g.bs - 2 * g.s_rf + 2 * k + leg]);
    }
  if (kCorr) corr_stage(s, g, t, row, tile, tid, corr, mom, partial, count);
  band_stages_tc<kRds>(s, g, t, row, tid, io);
}

template <bool kRds, bool kCorr, bool kBf16>
__global__ void __launch_bounds__(kThreads, kBf16 ? kTcBlocks : kFullBlocks)
    frontend_full_kernel(
    const uint8_t* __restrict__ iq_u8, const float* __restrict__ h_rf,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    const float* __restrict__ iq_tail, float* __restrict__ iq_tail_out,
    const float* __restrict__ corr, float* __restrict__ mom,
    float* __restrict__ partial, int* __restrict__ count, BandIO io,
    Geometry g) {
  extern __shared__ float4 smem4[];
  if constexpr (kBf16) {
    frontend_full_tc<kRds, kCorr>(reinterpret_cast<unsigned char*>(smem4),
                                  iq_u8, h_rf, h_bank, h_carrier, iq_tail,
                                  iq_tail_out, corr, mom, partial, count, io,
                                  g);
  } else {
    const Smem s = carve(reinterpret_cast<float*>(smem4), g, kRds);
    const long long row = blockIdx.x;
    const int tile = blockIdx.y;
    const int tid = threadIdx.x;
    const Tile t = make_tile(g, tile, kRds);
    const uint8_t* x = iq_u8 + row * g.bs;
    const float* tail = iq_tail + row * 2 * g.s_rf;  // [2, s_rf]

    rf::load_taps(s.hs, g, h_rf, tid);
    load_taps(s, g, h_bank, kRds ? h_carrier : nullptr, bank_rows(kRds),
              tid);
    if (t.first && tid == 0) {
      s.iq_i[g.s_b] = io.prev_i[row];
      s.iq_q[g.s_b] = io.prev_q[row];
    }
    rf::rf_stage<false, false>(
        s, g, t.g0, t.m1, t.l0,
        rf::Pairs{reinterpret_cast<const uint16_t*>(x)}, tail, tid);
    if (t.last)
      for (int j = tid; j < 2 * g.s_rf; j += kThreads) {
        // next RF tail, [2, s_rf], from the raw block's last 2*s_rf bytes
        const int leg = j / g.s_rf;
        const int k = j % g.s_rf;
        iq_tail_out[row * 2 * g.s_rf + j] =
            norm(x[g.bs - 2 * g.s_rf + 2 * k + leg]);
      }
    if (kCorr) corr_stage(s, g, t, row, tile, tid, corr, mom, partial, count);
    band_stages<kRds>(s, g, t, row, tid, io);
  }
}

template <bool kRds, bool kBf16>
__global__ void __launch_bounds__(kThreads, kBf16 ? kTcBlocks : 1)
    frontend_if_kernel(
    const float* __restrict__ i_if, const float* __restrict__ q_if,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    BandIO io, Geometry g) {
  extern __shared__ float4 smem4[];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const Tile t = make_tile(g, blockIdx.y, kRds, kBf16);
  const long long ro = row * g.n_out;
  if constexpr (kBf16) {
    const TcSmem s =
        carve_tc(reinterpret_cast<unsigned char*>(smem4), g, kRds);
    load_frags<kRds>(s, g, nullptr, h_bank, h_carrier, tid);
    if (t.first && tid == 0) {
      s.iq_i[g.s_b] = io.prev_i[row];
      s.iq_q[g.s_b] = io.prev_q[row];
    }
    for (int m = t.g0 + tid; m < t.m1; m += kThreads) {
      s.iq_i[m - t.q_base] = i_if[ro + m];
      s.iq_q[m - t.q_base] = q_if[ro + m];
    }
    __syncthreads();
    band_stages_tc<kRds>(s, g, t, row, tid, io);
  } else {
    const Smem s = carve(reinterpret_cast<float*>(smem4), g, kRds);
    load_taps(s, g, h_bank, kRds ? h_carrier : nullptr, bank_rows(kRds),
              tid);
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
    band_stages<kRds>(s, g, t, row, tid, io);
  }
}

template <bool kRds, bool kCorr, bool kBf16>
int launch_full(const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
                const float* h_carrier, const float* iq_tail,
                float* iq_tail_out, const float* corr, float* mom,
                float* partial, int* count, const BandIO& io,
                const Geometry& g, long long c, cudaStream_t stream) {
  if (!(kBf16 ? plan_ok_tc(g) : plan_ok(g)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBf16 ? smem_bytes_tc(g, kRds, kCorr)
                            : smem_floats(g, kRds, kCorr) * sizeof(float);
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
  if (!(kBf16 ? plan_ok_tc(g) : plan_ok(g)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBf16 ? smem_bytes_tc(g, kRds, false)
                            : smem_floats(g, kRds, false) * sizeof(float);
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
// (k_rf = 0, decim = 1, sub = 0, corr = 0); bf16 != 0: the tensor-core
// design.  frontend_cuda._smem_bytes computes the same; the wrappers check
// it against the card's 227 KB before a launch.
extern "C" long long dy4_frontend_smem(int tile, int sub, int decim,
                                       int k_rf, int kb, int rds, int corr,
                                       int bf16) {
  const Geometry g = make_geometry(2LL * decim * tile, decim, k_rf, kb,
                                   rds != 0, tile, sub, bf16 != 0);
  return static_cast<long long>(
      bf16 ? smem_bytes_tc(g, rds != 0, corr != 0)
           : smem_floats(g, rds != 0, corr != 0) * sizeof(float));
}

// Thread blocks an SM of one instantiation (B6 where if_kernel != 0) at
// `smem` bytes of dynamic shared memory, as the card's occupancy
// calculator counts them; a negative cudaError on failure.  For reports.
extern "C" int dy4_frontend_blocks(int if_kernel, int rds, int corr,
                                   int bf16, long long smem) {
  int n = 0;
  cudaError_t err;
  auto count = [&](auto kernel) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kThreads, static_cast<size_t>(smem));
  };
  if (if_kernel)
    rds ? (bf16 ? count(frontend_if_kernel<true, true>)
                : count(frontend_if_kernel<true, false>))
        : (bf16 ? count(frontend_if_kernel<false, true>)
                : count(frontend_if_kernel<false, false>));
  else if (corr)
    rds ? (bf16 ? count(frontend_full_kernel<true, true, true>)
                : count(frontend_full_kernel<true, true, false>))
        : (bf16 ? count(frontend_full_kernel<false, true, true>)
                : count(frontend_full_kernel<false, true, false>));
  else
    rds ? (bf16 ? count(frontend_full_kernel<true, false, true>)
                : count(frontend_full_kernel<true, false, false>))
        : (bf16 ? count(frontend_full_kernel<false, false, true>)
                : count(frontend_full_kernel<false, false, false>));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// B1.  Shapes (all row-major, float32 unless said): iq_u8 [c, bs] u8,
// h_rf [k_rf], h_bank [nb, kb] (nb >= 3 with rds, >= 2 without; only the
// first rows are read), h_carrier [kb], iq_tail [c, 2, k_rf-1],
// prev_i/prev_q [c], bank_tail [c, kb-1], mono_delay [c, kb/2],
// carrier_tail [c, kb-1], rds_delay [c, kb/2]; the five outputs
// [c, bs/2/decim] and the new tails in the shapes of the old ones.  With
// rds = 0, h_carrier, carrier_tail, rds_delay, carrier, rdsdel and their
// new tails are not touched and may be null.  bf16 != 0: the tensor-core
// design (the note at the top; it rounds the taps), whose plan's sub is a
// multiple of 128.  tile, sub: the plan (frontend_cuda._tile_plan).
// Returns cudaGetLastError() after the launch (0 = launched),
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
  const Geometry g =
      make_geometry(bs, decim, k_rf, kb, rds != 0, tile, sub, bf16 != 0);
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
  const Geometry g =
      make_geometry(bs, decim, k_rf, kb, rds != 0, tile, sub, bf16 != 0);
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
  const Geometry g =
      make_geometry(2LL * n_out, 1, 0, kb, rds != 0, tile, 0, bf16 != 0);
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
