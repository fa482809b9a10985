// The RF stage of the receiver alone: u8 I/Q -> normalize -> the K-tap
// RF LPF decimating by `decim` on both legs -> the differentiator demod
// -> fm.  One kernel, rf_tile_kernel, over rf_stage.cuh's RF stage (B1's,
// frontend.cu), with two ways for the u8 block to reach it:
//
// B11 (Pairs)  replaces dy4tpu/ops/frontend_pallas.py :: fused_frontend_raw
//              (_kernel_raw): the interleaved u8 row [c, bs] read as 16-bit
//              I/Q pairs.
// B12 (Pairs)  replaces frontend_pallas.py :: fused_frontend (_kernel):
//              dy4tpu splits the block into 2D interleave/decimation phase
//              planes outside the kernel, a TPU layout ("phase dims go
//              LEADING so the kernel only ever slab-selects").  Here the
//              window's polyphase staging in shared memory is that split,
//              so B12 launches B11's kernel on the u8 row itself (its
//              wrapper keeps the (K-1) % D == 0 check).
// B13 (Words)  replaces frontend_pallas.py :: fused_frontend_raw_pm
//              (_kernel_raw_pm): the row as 32-bit words [c, bs/4], each
//              two I/Q pairs (little-endian: bytes 0 and 2 are I, 1 and 3
//              are Q).
//
// Contract: (iq_u8, h, iq_tail [c, 2, K-1], prev_i, prev_q [c]) -> fm
// [c, bs/2/D], the new iq_tail (the block's last K-1 complex samples,
// normalized: exact), and the new prev_i/prev_q (the last decimated I/Q).
//
// What bounds it on the card: the 2K float32 multiply-adds per fm sample
// (2 x 101 at modes 0-3) against the u8 read (bs bytes a row, the only
// stream that scales with the input; fm is 1/(2D) of it in floats): about
// even at D = 10.  The TPU kernels' banded tap-parity matrices and
// window/dot interleave are MXU and VMEM devices and are not copied.  The
// design:
//
//  * Grid (row, tile).  A tile is `tile` decimated outputs (the wrapper's
//    plan, frontend_cuda._rf_plan: at most 2048, the row split evenly), and
//    recomputes one I/Q sample before its first output, the demod's halo;
//    tile 0 takes the carried prev_i/prev_q there instead.
//  * rf_stage.cuh runs the tile's RF outputs in passes of `sub` outputs
//    (the window in polyphase order in shared memory, its first fetch
//    round prefetched into registers while the last pass multiplies), into
//    the tile's I/Q buffers; the demod then writes fm coalesced, and the
//    last tile writes prev_i/prev_q and the new iq_tail from the block's
//    last 2(K-1) bytes.
//  * Unlike B1, a thread makes its 4 outputs on both legs (mac4x2: one tap
//    load feeds 8 FMAs), and a pass takes up to two fetch rounds (the
//    plan's RF_PASS_SAMPLES), so at D = 10 a pass still has work for
//    every thread; the second round is loaded while the block waits.
//  * A block takes the taps, its I/Q and the window (about 87-94 KB at
//    modes 0-3), so 2 blocks share an SM, at up to 128 registers a thread.
//  * Where even one unit of 4 outputs needs more than one fetch round (a
//    long filter) the stage fills its window in several, and where the
//    smallest pass does not fit with the tile, the plan shrinks the tile:
//    every geometry whose first-port block fitted (a window of 256 +
//    (K-1)/D samples a phase) runs.
//
// Numerics: the normalize (x-128)/128 comes first and is exact in float32
// (the TPU kernels' -128*sum(h) epilogue cancels in float32 and is not
// copied).  Each output sums its taps in rf_stage.cuh's fixed order, so two
// plans give the same bits, and B11's I/Q, fm and prev_i/prev_q are B1's
// (fm shifted by B1's mono delay); fm matches the plain torch version to
// float32 tolerance, amplified by the demod's 1/power where the I/Q pass
// near the origin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rf_stage.cuh"

namespace {

using rf::kThreads;

constexpr int kRfBlocks = 2;   // blocks an SM: 128 registers a thread

enum Source { kPairs = 0, kWords = 1 };

// rf::Geometry: n_in, decim, s_rf, sub, nq, lp.
struct Geometry : rf::Geometry {
  long long bs;    // u8 bytes per row
  int n_out;       // decimated samples = n_in / decim
  int tile;        // outputs a tile owns
  int n_tiles;     // tiles a row
  int l_iq;        // floats of each I/Q buffer: the tile and its halo
};

Geometry make_geometry(long long bs, int decim, int k, int tile, int sub) {
  Geometry g;
  g.bs = bs;
  g.n_in = static_cast<int>(bs / 2);
  g.n_out = g.n_in / decim;
  g.decim = decim;
  g.s_rf = k - 1;
  g.sub = sub;
  g.nq = rf::round4(g.s_rf / decim + 1);
  g.lp = rf::window_row(sub + g.nq);
  g.tile = tile;
  g.n_tiles = tile > 0 ? (g.n_out + tile - 1) / tile : 0;
  g.l_iq = rf::round4(tile + 1);
  return g;
}

bool plan_ok(const Geometry& g) {
  return g.tile >= 1 && g.n_tiles >= 1 && g.n_tiles <= 65535 &&
         g.sub >= rf::kR && g.sub % rf::kR == 0;
}

// Shared memory, in floats, in this order (each a multiple of 4): the taps
// hs [decim, nq], the tile's I/Q iq_i, iq_q [l_iq] (slot l holds output
// m0 - 1 + l), the window [2, decim, lp].
size_t smem_floats(const Geometry& g) {
  return static_cast<size_t>(g.decim) * g.nq +
         2 * static_cast<size_t>(g.l_iq) +
         2 * static_cast<size_t>(g.decim) * g.lp;
}

// kLong: a pass's window may take more than one fetch round (launched
// where it does).
template <class Src, bool kLong>
__global__ void __launch_bounds__(kThreads, kRfBlocks) rf_tile_kernel(
    const uint8_t* __restrict__ iq_u8, const float* __restrict__ h,
    const float* __restrict__ iq_tail, const float* __restrict__ prev_i,
    const float* __restrict__ prev_q, float* __restrict__ fm,
    float* __restrict__ iq_tail_out, float* __restrict__ prev_i_out,
    float* __restrict__ prev_q_out, Geometry g) {
  extern __shared__ float4 smem4[];
  rf::Bufs s;
  s.hs = reinterpret_cast<float*>(smem4);
  s.iq_i = s.hs + g.decim * g.nq;
  s.iq_q = s.iq_i + g.l_iq;
  s.win_i = s.iq_q + g.l_iq;
  s.win_q = s.win_i + g.decim * g.lp;
  const long long row = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const bool first = tile == 0;
  const int m0 = tile * g.tile;
  const int m1 = min(m0 + g.tile, g.n_out);
  const int q_base = m0 - 1;            // iq[l] is output q_base + l
  const int g0 = first ? 0 : q_base;    // the first output computed
  const Src x{reinterpret_cast<decltype(Src::x)>(iq_u8 + row * g.bs)};
  const float* tail = iq_tail + row * 2 * g.s_rf;  // [2, s_rf]

  rf::load_taps(s.hs, g, h, tid);
  if (first && tid == 0) {  // the sample before the block: the carried one
    s.iq_i[0] = prev_i[row];
    s.iq_q[0] = prev_q[row];
  }
  rf::rf_stage<kLong, true>(s, g, g0, m1, g0 - q_base, x, tail, tid);

  float* out = fm + row * g.n_out;
  for (int m = m0 + tid; m < m1; m += kThreads) {
    const int l = m - q_base;
    out[m] = rf::fm_demod(s.iq_i[l], s.iq_q[l], s.iq_i[l - 1], s.iq_q[l - 1]);
  }
  if (tile == g.n_tiles - 1) {
    if (tid == 0) {
      prev_i_out[row] = s.iq_i[g.n_out - 1 - q_base];
      prev_q_out[row] = s.iq_q[g.n_out - 1 - q_base];
    }
    // the next RF tail, [2, s_rf], from the block's last 2*s_rf bytes
    for (int j = tid; j < 2 * g.s_rf; j += kThreads) {
      const int leg = j / g.s_rf;
      const int k = j % g.s_rf;
      iq_tail_out[row * 2 * g.s_rf + j] =
          rf::norm(x.byte(g.bs - 2LL * g.s_rf + 2 * k + leg));
    }
  }
}

template <class Src, bool kLong>
int launch_kernel(const uint8_t* iq_u8, const float* h, const float* iq_tail,
                  const float* prev_i, const float* prev_q, float* fm,
                  float* iq_tail_out, float* prev_i_out, float* prev_q_out,
                  const Geometry& g, long long c, cudaStream_t stream) {
  const size_t smem = smem_floats(g) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      rf_tile_kernel<Src, kLong>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(c), static_cast<unsigned>(g.n_tiles));
  rf_tile_kernel<Src, kLong><<<grid, kThreads, smem, stream>>>(
      iq_u8, h, iq_tail, prev_i, prev_q, fm, iq_tail_out, prev_i_out,
      prev_q_out, g);
  return static_cast<int>(cudaGetLastError());
}

template <class Src>
int launch(const uint8_t* iq_u8, const float* h, const float* iq_tail,
           const float* prev_i, const float* prev_q, float* fm,
           float* iq_tail_out, float* prev_i_out, float* prev_q_out,
           const Geometry& g, long long c, cudaStream_t stream) {
  if (!plan_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  return g.decim * (g.sub + g.nq) > rf::kRound
             ? launch_kernel<Src, true>(iq_u8, h, iq_tail, prev_i, prev_q, fm,
                                        iq_tail_out, prev_i_out, prev_q_out,
                                        g, c, stream)
             : launch_kernel<Src, false>(iq_u8, h, iq_tail, prev_i, prev_q,
                                         fm, iq_tail_out, prev_i_out,
                                         prev_q_out, g, c, stream);
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes for tiles of
// `tile` outputs and RF passes of `sub` outputs at decimation `decim`
// with `k` taps (the same for both sources).  frontend_cuda._rf_smem_bytes
// computes the same; the wrappers check it against the card's 227 KB
// before a launch.
extern "C" long long dy4_frontend_rf_smem(int tile, int sub, int decim,
                                          int k) {
  const Geometry g = make_geometry(2LL * decim * tile, decim, k, tile, sub);
  return static_cast<long long>(smem_floats(g) * sizeof(float));
}

// B11 / B12 (source 0: the rows as 16-bit pairs), B13 (source 1: as 32-bit
// words).  iq_u8 [c, bs] u8; h [k], iq_tail and iq_tail_out [c, 2, k-1],
// prev_i/prev_q and their outputs [c], fm [c, bs/2/decim], all float32
// and contiguous.  The caller guarantees bs % (2*decim) == 0, bs/2 >= k-1
// and bs >= 2*decim, for source 1 bs % 4 == 0.  tile, sub: the plan
// (frontend_cuda._rf_plan).  Returns cudaGetLastError() after the launch
// (0 = launched), cudaErrorInvalidValue for a plan it cannot run.
extern "C" int dy4_frontend_rf(int source, const uint8_t* iq_u8,
                               const float* h, const float* iq_tail,
                               const float* prev_i, const float* prev_q,
                               float* fm, float* iq_tail_out,
                               float* prev_i_out, float* prev_q_out,
                               long long c, long long bs, int decim, int k,
                               int tile, int sub, void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(bs, decim, k, tile, sub);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (source) {
    case kPairs:
      return launch<rf::Pairs>(iq_u8, h, iq_tail, prev_i, prev_q, fm,
                               iq_tail_out, prev_i_out, prev_q_out, g, c,
                               st);
    case kWords:
      return launch<rf::Words>(iq_u8, h, iq_tail, prev_i, prev_q, fm,
                               iq_tail_out, prev_i_out, prev_q_out, g, c,
                               st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
