// Audio back end of the rational modes (U > 1): stereo mix, the mono and
// stereo rational resamplers, and the L/R matrix, in one pass.
//
// Replaces dy4tpu/ops/resample_pallas.py :: fused_audio_backend_rational
// (_audio_kernel).  For each output m of a row and each leg,
//   y[m] = sum_w x_ext[w] * h[(K-1) - (w*U + pad_lo - m*D)]
// over x_ext = [tail || x] (S + N samples), S = (K-1)//U, pad_lo =
// (K-1) - S*U (dy4tpu/ops/fir.py).  Substituting pad_lo, the tap index is
// S*U + m*D - w*U, so the newest input an output reads is
// wmax(m) = S + (m*D)//U, with tap r = (m*D) % U, and the older ones step
// back one input and U taps at a time:
//   y[m] = sum_{t=0..S} x_ext[wmax(m) - t] * h[r + t*U]
// (a tap index >= K contributes nothing).  Every output reads exactly
// S+1 = ceil(K/U) inputs, all inside x_ext.  The mono leg is fm_delayed,
// the stereo leg 2*nco*stereo_band formed on chip; left = mono + stereo,
// right = mono - stereo.  The new tails are the last S samples of each
// input leg.
//
// What bounds it on the card: at modes 2 and 3 (147/800, 147/1280 with
// K = 14847) each output costs 2 x 101 MACs, and a 9600- or 12800-sample
// row gives 1764 or 1470 outputs, so the arithmetic is small and the
// kernel is bound by reading the three IF-rate inputs and by staging the
// 59 KB of taps.  The design gives each thread block one row and a tile
// of kTile outputs, one per thread, and stages in shared memory
//   * the taps once per block, reordered to polyphase [U][S+1] so that a
//     thread's taps are contiguous (neighbouring outputs sit U/D phases
//     apart, so the natural order would stride by U),
//   * the tile's input window of each leg (about kTile*D/U + S samples),
//     with the stereo mix formed as it is loaded.
// No zero-stuffed stream and no banded matrix (the TPU's per-tile [W, 128]
// MXU operands) exist.  kTile = 512: a block then holds 82 KB (mode 2) or
// 96 KB (mode 3) of shared memory, two blocks fit one SM (1024 threads),
// and the taps are staged
// half as often as with 256-output tiles.  The last tile of a row is
// ragged; every loop masks it.
//
// Numerics: nco*sb*2 is the plain version's product in its order, so the
// stereo tail is exact; the sums match the plain torch version to float32
// tolerance, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;  // outputs per thread block, one per thread

struct Geometry {
  int n_in;    // input samples per row
  int m_out;   // outputs per row = n_in * up / down
  int up;
  int down;
  int k;       // taps
  int s;       // (k-1)/up: tail length; every output reads s+1 inputs
  int win;     // x_ext samples a tile's window holds
};

Geometry make_geometry(int n_in, int up, int down, int k) {
  Geometry g;
  g.n_in = n_in;
  g.m_out = static_cast<int>(static_cast<long long>(n_in) * up / down);
  g.up = up;
  g.down = down;
  g.k = k;
  g.s = (k - 1) / up;
  // wmax(m0 + kTile - 1) - wmax(m0) <= ceil((kTile-1)*down/up), plus the
  // s older inputs of the first output and the newest one itself
  g.win = g.s + static_cast<int>(
      (static_cast<long long>(kTile - 1) * down + up - 1) / up) + 1;
  return g;
}

size_t smem_bytes(const Geometry& g) {
  return (static_cast<size_t>(g.up) * (g.s + 1) + 2 * g.win) *
         sizeof(float);
}

__global__ void __launch_bounds__(kTile) audio_rational_kernel(
    const float* __restrict__ fmd, const float* __restrict__ sb,
    const float* __restrict__ nco, const float* __restrict__ h,
    const float* __restrict__ mono_tail,
    const float* __restrict__ stereo_tail, float* __restrict__ mono,
    float* __restrict__ left, float* __restrict__ right,
    float* __restrict__ mono_tail_out, float* __restrict__ stereo_tail_out,
    Geometry g) {
  extern __shared__ float smem[];
  const int taps = g.s + 1;             // taps per polyphase branch
  float* hp = smem;                     // [up][taps]
  float* xm = hp + g.up * taps;         // [win] mono window of x_ext
  float* xs = xm + g.win;               // [win] stereo window

  const long long row = blockIdx.y;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTile;
  const long long ri = row * g.n_in;
  // window start: the oldest input of output m0
  const int w0 = static_cast<int>(static_cast<long long>(m0) * g.down /
                                  g.up);

  for (int i = tid; i < g.up * taps; i += kTile) {
    const int r = i / taps;
    const int t = i - r * taps;
    const int j = r + t * g.up;
    hp[i] = j < g.k ? h[j] : 0.0f;
  }
  for (int u = tid; u < g.win; u += kTile) {
    const int w = w0 + u;               // x_ext index
    float vm = 0.0f, vs = 0.0f;
    if (w < g.s) {
      vm = mono_tail[row * g.s + w];
      vs = stereo_tail[row * g.s + w];
    } else if (w - g.s < g.n_in) {
      const long long i = ri + (w - g.s);
      vm = fmd[i];
      vs = nco[i] * sb[i] * 2.0f;
    }
    xm[u] = vm;
    xs[u] = vs;
  }
  if (blockIdx.x == 0) {
    for (int j = tid; j < g.s; j += kTile) {
      const long long i = ri + g.n_in - g.s + j;
      mono_tail_out[row * g.s + j] = fmd[i];
      stereo_tail_out[row * g.s + j] = nco[i] * sb[i] * 2.0f;
    }
  }
  __syncthreads();

  const int m = m0 + tid;
  if (m >= g.m_out) return;
  const long long md = static_cast<long long>(m) * g.down;
  const int r = static_cast<int>(md % g.up);
  const int wl = g.s + static_cast<int>(md / g.up) - w0;  // window index
  const float* hr = hp + r * taps;
  float am = 0.0f, as = 0.0f;
  for (int t = 0; t < taps; ++t) {
    am += hr[t] * xm[wl - t];
    as += hr[t] * xs[wl - t];
  }
  const long long o = row * g.m_out + m;
  mono[o] = am;
  left[o] = am + as;
  right[o] = am - as;
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes at this geometry:
// the wrapper checks it against the card's 227 KB before a launch.
extern "C" long long dy4_audio_rational_smem(int n_in, int up, int down,
                                             int k) {
  return static_cast<long long>(smem_bytes(make_geometry(n_in, up, down, k)));
}

// fmd, sb, nco: [c, n_in]; h: [k]; tails [c, (k-1)/up]; outputs
// [c, n_in*up/down] and the new tails.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int dy4_audio_rational(
    const float* fmd, const float* sb, const float* nco, const float* h,
    const float* mono_tail, const float* stereo_tail, float* mono,
    float* left, float* right, float* mono_tail_out, float* stereo_tail_out,
    long long c, int n_in, int up, int down, int k, void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(n_in, up, down, k);
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      audio_rational_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.m_out + kTile - 1) / kTile, static_cast<unsigned>(c));
  audio_rational_kernel<<<grid, kTile, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      fmd, sb, nco, h, mono_tail, stereo_tail, mono, left, right,
      mono_tail_out, stereo_tail_out, g);
  return static_cast<int>(cudaGetLastError());
}
