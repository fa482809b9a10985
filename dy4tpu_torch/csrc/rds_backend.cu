// RDS back end: quadrature mix, rational U/D resampler, RRC matched
// filter; one thread block per (channel, I/Q leg).
//
// Replaces dy4tpu/ops/resample_pallas.py :: fused_rds_backend
// (_rds_kernel).  Per row and leg:
//   1. x_ext = [lpf_tail || nco * rds_delayed]           (S + N samples)
//   2. y[m] = sum_w x_ext[w] * h[(K-1) - (w*U + pad_lo - m*D)] over the
//      taps in [0, K), pad_lo = (K-1) - S*U    (dy4tpu/ops/fir.py:76-121)
//   3. bb[m] = sum_j h_rrc[j] * [rrc_tail || y][m + S2 - j], S2 = K2-1
// S = (K-1)//U input samples of history, in input-sample units.  The new
// LPF tail is the last S mixed samples, the new RRC tail the last S2
// resampled ones.
//
// What bounds it on the card: at mode 0 (U/D = 19/120, K = 1919) the
// resampler needs only about K/U = 101 MACs per output, and the block's
// 7680 input samples give 1216 outputs, so the work per row is small
// and the input read dominates.  The design keeps the mixed stream and
// the resampled stream in shared memory (they never touch device
// memory), visits only the valid taps of each output (no zero-stuffed
// samples, no banded matrix), and spreads the C x 2 independent legs
// over the card's SMs.  1216 outputs is not a multiple of the thread
// count; every loop masks its ragged end.
//
// Numerics: the sums match the plain torch version to float32
// tolerance; the LPF tail is the mixed stream itself and is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rds_backend_kernel(
    const float* __restrict__ rds, const float* __restrict__ nco_i,
    const float* __restrict__ nco_q, const float* __restrict__ h_lpf,
    const float* __restrict__ h_rrc, const float* __restrict__ lpf_tail_i,
    const float* __restrict__ lpf_tail_q,
    const float* __restrict__ rrc_tail_i,
    const float* __restrict__ rrc_tail_q, float* __restrict__ bb_i,
    float* __restrict__ bb_q, float* __restrict__ lpf_tail_i_out,
    float* __restrict__ lpf_tail_q_out, float* __restrict__ rrc_tail_i_out,
    float* __restrict__ rrc_tail_q_out, int n_in, int m_out, int up,
    int down, int k, int k2) {
  extern __shared__ float smem[];
  const int s = (k - 1) / up;
  const int pad_lo = (k - 1) - s * up;
  const int s2 = k2 - 1;
  float* hl = smem;            // [k]
  float* hr = hl + k;          // [k2]
  float* xe = hr + k2;         // [s + n_in]
  float* ye = xe + s + n_in;   // [s2 + m_out]

  const int leg = blockIdx.x;  // 0: I, 1: Q
  const long long row = blockIdx.y;
  const int tid = threadIdx.x;
  const float* nco = (leg ? nco_q : nco_i) + row * n_in;
  const float* x = rds + row * n_in;
  const float* ltail = (leg ? lpf_tail_q : lpf_tail_i) + row * s;
  const float* rtail = (leg ? rrc_tail_q : rrc_tail_i) + row * s2;
  float* bb = (leg ? bb_q : bb_i) + row * m_out;
  float* ltail_out = (leg ? lpf_tail_q_out : lpf_tail_i_out) + row * s;
  float* rtail_out = (leg ? rrc_tail_q_out : rrc_tail_i_out) + row * s2;

  // ---- 1. taps, the mixed stream and the carried histories
  for (int j = tid; j < k; j += kThreads) hl[j] = h_lpf[j];
  for (int j = tid; j < k2; j += kThreads) hr[j] = h_rrc[j];
  for (int w = tid; w < s; w += kThreads) xe[w] = ltail[w];
  for (int n = tid; n < n_in; n += kThreads) xe[s + n] = nco[n] * x[n];
  for (int w = tid; w < s2; w += kThreads) ye[w] = rtail[w];
  __syncthreads();
  for (int j = tid; j < s; j += kThreads) ltail_out[j] = xe[n_in + j];

  // ---- 2. polyphase resampler over the valid taps only
  const int last_w = s + n_in - 1;
  for (int m = tid; m < m_out; m += kThreads) {
    const int lo = m * down - pad_lo;    // w*up - lo is the flipped tap
    const int w_min = lo <= 0 ? 0 : (lo + up - 1) / up;
    int w_max = (lo + k - 1) / up;
    if (w_max > last_w) w_max = last_w;
    float acc = 0.0f;
    for (int w = w_min; w <= w_max; ++w)
      acc += xe[w] * hl[(k - 1) - (w * up - lo)];
    ye[s2 + m] = acc;
  }
  __syncthreads();
  for (int j = tid; j < s2; j += kThreads) rtail_out[j] = ye[m_out + j];

  // ---- 3. RRC matched filter
  for (int m = tid; m < m_out; m += kThreads) {
    float acc = 0.0f;
    const float* y = ye + s2 + m;
    for (int j = 0; j < k2; ++j) acc += hr[j] * y[-j];
    bb[m] = acc;
  }
}

}  // namespace

// rds, nco_i, nco_q: [c, n_in]; h_lpf [k]; h_rrc [k2]; lpf tails
// [c, (k-1)/up]; rrc tails [c, k2-1]; bb_i/bb_q [c, n_in*up/down] and the
// new tails.  Returns cudaGetLastError() after the launch.
extern "C" int dy4_rds_backend(
    const float* rds, const float* nco_i, const float* nco_q,
    const float* h_lpf, const float* h_rrc, const float* lpf_tail_i,
    const float* lpf_tail_q, const float* rrc_tail_i,
    const float* rrc_tail_q, float* bb_i, float* bb_q,
    float* lpf_tail_i_out, float* lpf_tail_q_out, float* rrc_tail_i_out,
    float* rrc_tail_q_out, long long c, int n_in, int up, int down, int k,
    int k2, void* stream) {
  if (c <= 0) return 0;
  const int m_out = static_cast<int>(static_cast<long long>(n_in) * up /
                                     down);
  const int s = (k - 1) / up;
  const size_t smem = (static_cast<size_t>(k) + k2 + s + n_in +
                       (k2 - 1) + m_out) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rds_backend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2, static_cast<unsigned>(c));
  rds_backend_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      rds, nco_i, nco_q, h_lpf, h_rrc, lpf_tail_i, lpf_tail_q, rrc_tail_i,
      rrc_tail_q, bb_i, bb_q, lpf_tail_i_out, lpf_tail_q_out,
      rrc_tail_i_out, rrc_tail_q_out, n_in, m_out, up, down, k, k2);
  return static_cast<int>(cudaGetLastError());
}
