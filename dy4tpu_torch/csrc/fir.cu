// B14 fir_decim_kernel replaces dy4tpu/ops/fir_pallas.py ::
// block_fir_decim_pallas: the stateful decimating block FIR on float32
// rows,
//
//     y[m] = sum_{a=0..K-1} h[K-1-a] * ext[m*D + a],   ext = [state || x],
//
// with the last K-1 samples of ext carried out as the new state (exact).
//
// What bounds it on the card: the bytes.  At mode 0's RF legs of 512
// channels ([1024, 76800], K=101, D=10) a call reads 314.6 MB of x and
// writes 31.5 MB of y (346.85 MB with the states: 0.1035 ms at 3.35
// TB/s), against 1.589 GFLOP (0.0237 ms at 67 TFLOP/s float32).  So the
// multiply-adds have to run while the rows stream in.  The first port
// loaded a block's whole window (dividing twice a sample for its slot),
// synchronized, then made one output a thread at two shared-memory loads
// an FMA: its fill and its MACs took turns, at 5x the bound.  The TPU
// kernel's phase-major split outside the kernel, its (8, 128) tiles and
// its K/D <= 128 window margin are VMEM devices and are not copied.
//
// The design (the plan, a rule, from fir_cuda._fir_plan; Geom below):
//   * Grid (row, tile): a block of 128 threads owns a tile of at most 1024
//     outputs of one row, the row split evenly (into tiles of down to 128
//     where the grid would hold fewer than two blocks an SM); the tile
//     reads its own K-1 halo again, tile 0 from the carried state, and
//     tile 0 writes the new state.
//   * The tile runs in passes of `sub` outputs (at most 512, 4 a thread).
//     A pass's window, ext samples [e0, e0 + D(sub + nq)), sits in shared
//     memory in polyphase order, ext sample e0 + v*D + r at [r][v], rows
//     padded by rf::window_row so that the fill's stores meet at most 2 to
//     a bank.
//   * The fill: every thread issues 4-byte cp.async copies, consecutive
//     threads on consecutive floats of the row (coalesced), each straight
//     into its polyphase slot; a thread's phase and slot are stepped from
//     copy to copy, not divided.  Samples of the halo below x come from
//     the state row by the same copy, samples past the row are stored as
//     zeros.  A ring of `stages` pass windows keeps the next passes'
//     copies in flight while this pass multiplies (commit and wait by
//     group).
//   * The MACs are rf_stage.cuh's: the taps by phase in shared memory
//     (rf::load_taps's layout, zeros to nq, a multiple of 4), a thread
//     makes 4 consecutive outputs by rf::mac4, 16-byte window loads each
//     feeding 4 FMAs.
//   * On the H100 the shared memory a block holds decides: a stage of the
//     RF geometry's window is 21 KB, and ten one-stage blocks an SM hide
//     the fill behind one another's MACs better than five two-stage ones
//     (chip_smoke.py's sweep), so the plan takes one stage where the grid
//     fills the card and the ring of two where it does not.  A block of
//     two rows (rf::mac4x2, a tap load feeding 8 FMAs) and 16-byte copies
//     restaged into polyphase order were both slower at every plan
//     measured, and are not kept.
//   * Where the taps and windows do not fit the shared memory the plan
//     shrinks the pass, then the ring: every (K, D) and row length the
//     first port served runs.
//
// Numerics: each output sums its taps phase by phase (r outer, tap q
// inner) with FMAs from +0, the zero taps at the end of each phase row:
// rf_stage.cuh's order, whatever the plan, so two plans give the same
// bits, and on B11's normalized RF legs B14's I/Q is B11's.  The new
// state is a copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "rf_stage.cuh"

namespace {

constexpr int kThreads = 128;    // threads a block (fir_cuda.FIR_THREADS)
constexpr int kMaxStages = 3;    // pass windows in the copy ring, at most
constexpr int kSmemMax = 232448; // kernels.SMEM_MAX: 227 KB a block
constexpr int kMaxTiles = 65535; // grid.y

// rf::Geometry (decim, s_rf = K-1, sub, nq, lp; n_in unused) and the plan.
struct Geom : rf::Geometry {
  long long n;     // input samples a row
  int n_out;       // n / decim
  int tile;        // outputs a tile owns
  int n_tiles;     // tiles a row
  int stages;      // pass windows in the ring
  int w;           // window samples a pass: decim * (sub + nq)
  int stage;       // floats of one ring stage: decim * lp
  int dr, dslot;   // a fill copy's step to the next: kThreads samples on
};

Geom make_geom(long long n, int decim, int k, int tile, int sub,
               int stages) {
  Geom g;
  g.n_in = 0;
  g.n = n;
  g.n_out = static_cast<int>(n / decim);
  g.decim = decim;
  g.s_rf = k - 1;
  g.sub = sub;
  g.nq = rf::round4(g.s_rf / decim + 1);
  g.lp = rf::window_row(sub + g.nq);
  g.tile = tile;
  g.n_tiles = tile > 0 ? (g.n_out + tile - 1) / tile : 0;
  g.stages = stages;
  g.w = decim * (sub + g.nq);
  g.stage = decim * g.lp;
  g.dr = kThreads % decim;
  g.dslot = g.dr * g.lp + kThreads / decim;
  return g;
}

// Shared memory, in floats: the taps hs [decim, nq], then the ring of
// `stages` windows [decim, lp].
long long smem_floats(const Geom& g) {
  return static_cast<long long>(g.decim) * g.nq +
         static_cast<long long>(g.stages) * g.stage;
}

bool plan_ok(const Geom& g) {
  return g.n_out >= 1 && g.n / g.decim < (1LL << 30) && g.tile >= 1 &&
         g.n_tiles <= kMaxTiles && g.sub >= rf::kR &&
         g.sub % rf::kR == 0 && g.stages >= 1 && g.stages <= kMaxStages &&
         smem_floats(g) * 4 <= kSmemMax;
}

// Every copy group but the newest `pending` (< kMaxStages) has landed.
__device__ __forceinline__ void wait_pending(int pending) {
  if (pending == 0)
    cpa::wait<0>();
  else if (pending == 1)
    cpa::wait<1>();
  else
    cpa::wait<2>();
}

// The copies of one pass into a ring stage `win` [decim, lp]: the window
// samples l < w, ext sample e0 + l at slot [l % decim][l / decim], from
// the row `xr` or its state `sr`.  Thread tid takes l = tid + j *
// kThreads; its first slot is slot0 and its phase r0, stepped per copy by
// g.dr / g.dslot.
__device__ __forceinline__ void fill(float* win, const Geom& g,
                                     const float* xr, const float* sr,
                                     long long e0, int r0, int slot0,
                                     int tid) {
  const int d = g.decim;
  const int wrap = 1 - d * g.lp;
  int r = r0, slot = slot0;
  // window samples [0, lo) lie in the state, [lo, hi) in x, [hi, w) past
  // the row
  const long long lo64 = g.s_rf - e0, hi64 = g.s_rf + g.n - e0;
  const int lo = static_cast<int>(lo64 < 0 ? 0 : lo64 < g.w ? lo64 : g.w);
  const int hi = static_cast<int>(hi64 < 0 ? 0 : hi64 < g.w ? hi64 : g.w);
  if (lo == 0 && hi == g.w) {  // all in x: every pass but a row's ends
    const float* src = xr + (e0 - g.s_rf) + tid;
#pragma unroll 4
    for (int l = tid; l < g.w; l += kThreads) {
      cpa::copy4(win + slot, src);
      src += kThreads;
      r += g.dr;
      slot += g.dslot;
      if (r >= d) {
        r -= d;
        slot += wrap;
      }
    }
    return;
  }
  for (int l = tid; l < g.w; l += kThreads) {
    if (l < lo)
      cpa::copy4(win + slot, sr + (e0 + l));
    else if (l < hi)
      cpa::copy4(win + slot, xr + (e0 - g.s_rf + l));
    else
      win[slot] = 0.0f;
    r += g.dr;
    slot += g.dslot;
    if (r >= d) {
      r -= d;
      slot += wrap;
    }
  }
}

// 4 outputs to out (n_o of them wanted), a 16-byte store where it can
__device__ __forceinline__ void store4(float* out, const float (&acc)[rf::kR],
                                       int n_o) {
  if (n_o >= rf::kR && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    *reinterpret_cast<float4*>(out) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < rf::kR; ++k)
    if (k < n_o) out[k] = acc[k];
}

__global__ void __launch_bounds__(kThreads) fir_decim_kernel(
    const float* __restrict__ x, const float* __restrict__ h,
    const float* __restrict__ state, float* __restrict__ y,
    float* __restrict__ state_out, Geom g) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [decim, nq]
  float* ring = hs + g.decim * g.nq;            // [stages][decim, lp]
  const int d = g.decim, s = g.s_rf;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int m0 = blockIdx.y * g.tile;
  const int m1 = min(m0 + g.tile, g.n_out);
  const int passes = (m1 - m0 + g.sub - 1) / g.sub;
  const float* xr = x + row * g.n;
  const float* sr = state + row * s;
  float* yr = y + row * g.n_out;
  // this thread's first window sample, tid: its phase and slot
  const int r0 = tid % d;
  const int slot0 = r0 * g.lp + tid / d;

  rf::load_taps<kThreads>(hs, g, h, tid);
  if (blockIdx.y == 0) {
    // the new state, ext[n, n + s): x's last s samples (or, for a row
    // shorter than the state, partly the old state)
    for (int j = tid; j < s; j += kThreads) {
      const long long e = g.n + j;
      state_out[row * s + j] = e < s ? sr[e] : xr[e - s];
    }
  }
  const long long e_tile = static_cast<long long>(m0) * d;
  for (int p = 0; p < g.stages - 1; ++p) {
    if (p < passes)
      fill(ring + p * g.stage, g, xr, sr,
           e_tile + static_cast<long long>(p) * g.sub * d, r0, slot0, tid);
    cpa::commit();
  }
  for (int p = 0; p < passes; ++p) {
    __syncthreads();  // pass p - 1 multiplied: its stage is free
    const int q = p + g.stages - 1;
    if (q < passes)
      fill(ring + (q % g.stages) * g.stage, g, xr, sr,
           e_tile + static_cast<long long>(q) * g.sub * d, r0, slot0, tid);
    cpa::commit();
    wait_pending(g.stages - 1);
    __syncthreads();  // pass p's window (and the taps) in place

    const float* win = ring + (p % g.stages) * g.stage;
    const int mp = m0 + p * g.sub;
    const int n_p = min(g.sub, m1 - mp);
    for (int t0 = rf::kR * tid; t0 < n_p; t0 += rf::kR * kThreads) {
      float acc[1][rf::kR] = {};
      for (int r = 0; r < d; ++r)
        rf::mac4<1>(hs + r * g.nq, 0, win + r * g.lp + t0, g.nq / 4, acc);
      store4(yr + mp + t0, acc[0], n_p - t0);
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes at decimation
// `decim` with `k` taps, passes of `sub` outputs and a ring of `stages`.
// fir_cuda._fir_smem_bytes computes the same; the wrapper checks it
// against the card's 227 KB before a launch.
extern "C" long long dy4_fir_decim_smem(int decim, int k, int sub,
                                        int stages) {
  const Geom g = make_geom(decim, decim, k, 1, sub, stages);
  return smem_floats(g) * static_cast<long long>(sizeof(float));
}

// B14.  x [rows, n], h [k], state and state_out [rows, k-1], y
// [rows, n/decim], all float32 and contiguous; n % decim == 0.  tile,
// sub, stages: the plan (fir_cuda._fir_plan).  Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue, launching
// nothing, for a plan it cannot run.
extern "C" int dy4_fir_decim(const float* x, const float* h,
                             const float* state, float* y, float* state_out,
                             long long rows, long long n, int decim, int k,
                             int tile, int sub, int stages, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (decim < 1 || k < 1 || rows >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(n, decim, k, tile, sub, stages);
  if (!plan_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_floats(g)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_decim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>(g.n_tiles));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fir_decim_kernel<<<grid, kThreads, smem, st>>>(x, h, state, y, state_out,
                                                 g);
  return static_cast<int>(cudaGetLastError());
}
