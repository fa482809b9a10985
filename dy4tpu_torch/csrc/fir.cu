// B14 fir_decim_kernel replaces dy4tpu/ops/fir_pallas.py ::
// block_fir_decim_pallas: the stateful decimating block FIR on float32
// rows,
//
//     y[m] = sum_{a=0..K-1} h[K-1-a] * ext[m*D + a],   ext = [state || x],
//
// with the last K-1 samples of ext carried out as the new state (exact).
//
// What bounds it on the card: the rows are read once from device memory
// and y is 1/D of them, so the call is bound by its bytes (4(N + N/D) per
// row) if the K multiply-adds per output keep up.  The TPU kernel's
// phase-major split outside the kernel, its (8, 128) tiles and its
// double-buffered DMA are VMEM devices and are not copied, nor is its
// K/D <= 128 window margin.  Here a thread block takes one row's tile of
// kThreads outputs, loads the tile's window of ext (kThreads*D + K - 1
// samples, consecutive threads on consecutive floats) into shared memory
// in polyphase order, ext sample e0 + v*D + r at [r][v], and each thread
// sums its output phase by phase: tap a = q*D + r of output t is [r][t+q],
// so a warp reads 32 consecutive words for every tap, free of bank
// conflicts at any D.  A tile takes about 11 KB at D = 10, K = 101, so
// several blocks share an SM.
//
// Numerics: the taps are summed phase by phase with FMAs, in another order
// than the plain conv1d, so y matches it to float32 tolerance; the new
// state is a copy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // outputs per block, one per thread

struct Geom {
  long long n;     // input samples per row
  long long n_out; // n / decim
  int decim;
  int s;           // k - 1: the state
  int qmax;        // s / decim + 1: taps per phase, at most
  int lp;          // kThreads + s / decim: window samples per phase
};

Geom make_geom(long long n, int decim, int k) {
  Geom g;
  g.n = n;
  g.n_out = n / decim;
  g.decim = decim;
  g.s = k - 1;
  g.qmax = g.s / decim + 1;
  g.lp = kThreads + g.s / decim;
  return g;
}

// Shared memory, in floats: taps [D, qmax], the window [D, lp].
size_t smem_floats(const Geom& g) {
  return static_cast<size_t>(g.decim) * (g.qmax + g.lp);
}

__global__ void __launch_bounds__(kThreads) fir_decim_kernel(
    const float* __restrict__ x, const float* __restrict__ h,
    const float* __restrict__ state, float* __restrict__ y,
    float* __restrict__ state_out, Geom g) {
  extern __shared__ float smem[];
  const int d = g.decim;
  float* hs = smem;                  // [d, qmax]: hs[r][q] = h[s - qd - r]
  float* win = hs + d * g.qmax;      // [d, lp]
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.y) * kThreads;
  const long long e0 = m0 * d;       // ext sample of window slot 0
  const int w_len = d * g.lp;
  const float* xr = x + row * g.n;
  const float* st = state + row * g.s;

  for (int i = tid; i < d * g.qmax; i += kThreads) {
    const int a = (i % g.qmax) * d + i / g.qmax;
    hs[i] = a <= g.s ? h[g.s - a] : 0.0f;
  }
  for (int l = tid; l < w_len; l += kThreads) {
    const long long e = e0 + l;
    float v = 0.0f;
    if (e < g.s) {
      v = st[e];
    } else if (e - g.s < g.n) {
      v = xr[e - g.s];
    }
    win[(l % d) * g.lp + l / d] = v;
  }
  // the new state: ext[n, n + s), from the block or, for a block shorter
  // than the state, partly from the old state
  if (blockIdx.y == 0) {
    for (int k = tid; k < g.s; k += kThreads) {
      const long long e = g.n + k;
      state_out[row * g.s + k] = e < g.s ? st[e] : xr[e - g.s];
    }
  }
  __syncthreads();

  const long long m = m0 + tid;
  if (m >= g.n_out) return;
  float acc = 0.0f;
  for (int r = 0; r < d && r <= g.s; ++r) {
    const int nq = (g.s - r) / d + 1;
    const float* hr = hs + r * g.qmax;
    const float* wr = win + r * g.lp + tid;
    for (int q = 0; q < nq; ++q) acc = fmaf(hr[q], wr[q], acc);
  }
  y[row * g.n_out + m] = acc;
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes at decimation
// `decim` with `k` taps.  The wrapper checks it against the card's 227 KB
// before a launch.
extern "C" long long dy4_fir_decim_smem(int decim, int k) {
  return static_cast<long long>(smem_floats(make_geom(decim, decim, k)) *
                                sizeof(float));
}

// B14.  x [rows, n], h [k], state and state_out [rows, k-1], y
// [rows, n/decim], all float32 and contiguous; n % decim == 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dy4_fir_decim(const float* x, const float* h,
                             const float* state, float* y, float* state_out,
                             long long rows, long long n, int decim, int k,
                             void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const Geom g = make_geom(n, decim, k);
  const size_t smem = smem_floats(g) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_decim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((g.n_out + kThreads - 1) / kThreads));
  fir_decim_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(
                                               stream)>>>(x, h, state, y,
                                                          state_out, g);
  return static_cast<int>(cudaGetLastError());
}
