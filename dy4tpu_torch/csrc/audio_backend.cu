// Audio back end of the U=1 modes: stereo mix, the mono and stereo
// decimating LPFs, and the L/R matrix, in one pass.
//
// Replaces dy4tpu/ops/backend_pallas.py :: fused_audio_backend (_kernel).
// For each output sample m of a row:
//   mono[m]   = sum_j h[j] * [mono_tail   || fm_delayed][m*D + S - j]
//   stereo[m] = sum_j h[j] * [stereo_tail || 2*nco*sb  ][m*D + S - j]
//   left = mono + stereo, right = mono - stereo
// with S = K-1.  The new tails are the last S samples of each input
// stream (the mixed stereo stream for the stereo leg).
//
// What bounds it on the card: device memory.  Per output it reads D
// samples of three IF-rate streams and writes three outputs; the 2 x K
// MACs per output are far below the card's float32 rate.  The design
// gives each thread block one row and a tile of outputs, stages the
// tile's input windows in shared memory once (the mixed stereo stream is
// formed there, never written to device memory), and has each thread
// compute both legs of one output so the L/R matrix is its epilogue.
//
// Numerics: 2*nco*sb equals dy4tpu's nco*sb*2 exactly (scaling by 2 is
// exact), so the stereo tail is exact; the sums match the plain torch
// version to float32 tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // outputs per thread block (one per thread)

__global__ void __launch_bounds__(kTile) audio_backend_kernel(
    const float* __restrict__ fmd, const float* __restrict__ sb,
    const float* __restrict__ nco, const float* __restrict__ h,
    const float* __restrict__ mono_tail,
    const float* __restrict__ stereo_tail, float* __restrict__ mono,
    float* __restrict__ left, float* __restrict__ right,
    float* __restrict__ mono_tail_out, float* __restrict__ stereo_tail_out,
    int n_in, int m_out, int decim, int k) {
  extern __shared__ float smem[];
  const int s = k - 1;
  const int win = kTile * decim + s;   // ext samples a tile reads
  float* hs = smem;                    // [k]
  float* xm = hs + k;                  // [win] mono ext window
  float* xs = xm + win;                // [win] stereo ext window

  const long long row = blockIdx.y;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTile;
  const long long w0 = static_cast<long long>(m0) * decim;  // ext index
  const long long ri = row * n_in;

  for (int j = tid; j < k; j += kTile) hs[j] = h[j];
  for (int u = tid; u < win; u += kTile) {
    const long long w = w0 + u;
    float vm = 0.0f, vs = 0.0f;
    if (w < s) {
      vm = mono_tail[row * s + w];
      vs = stereo_tail[row * s + w];
    } else if (w - s < n_in) {
      const long long i = ri + (w - s);
      vm = fmd[i];
      vs = 2.0f * nco[i] * sb[i];
    }
    xm[u] = vm;
    xs[u] = vs;
  }
  if (blockIdx.x == 0) {
    for (int j = tid; j < s; j += kTile) {
      const long long i = ri + n_in - s + j;
      mono_tail_out[row * s + j] = fmd[i];
      stereo_tail_out[row * s + j] = 2.0f * nco[i] * sb[i];
    }
  }
  __syncthreads();

  const int m = m0 + tid;
  if (m >= m_out) return;
  const int base = tid * decim + s;
  float am = 0.0f, as = 0.0f;
  for (int j = 0; j < k; ++j) {
    am += hs[j] * xm[base - j];
    as += hs[j] * xs[base - j];
  }
  const long long o = row * m_out + m;
  mono[o] = am;
  left[o] = am + as;
  right[o] = am - as;
}

}  // namespace

// fmd, sb, nco: [c, n_in]; h: [k]; tails [c, k-1]; outputs [c, n_in/decim]
// and the new tails [c, k-1].  Returns cudaGetLastError() after the launch.
extern "C" int dy4_audio_backend(
    const float* fmd, const float* sb, const float* nco, const float* h,
    const float* mono_tail, const float* stereo_tail, float* mono,
    float* left, float* right, float* mono_tail_out, float* stereo_tail_out,
    long long c, int n_in, int decim, int k, void* stream) {
  if (c <= 0) return 0;
  const int m_out = n_in / decim;
  const size_t smem =
      (static_cast<size_t>(k) + 2 * (kTile * decim + (k - 1))) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      audio_backend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m_out + kTile - 1) / kTile, static_cast<unsigned>(c));
  audio_backend_kernel<<<grid, kTile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      fmd, sb, nco, h, mono_tail, stereo_tail, mono, left, right,
      mono_tail_out, stereo_tail_out, n_in, m_out, decim, k);
  return static_cast<int>(cudaGetLastError());
}
