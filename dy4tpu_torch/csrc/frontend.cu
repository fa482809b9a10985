// The whole LTI front half of one receiver block: one thread block per
// channel row.
//
// Replaces dy4tpu/ops/frontend_pallas.py :: fused_frontend_full
// (_kernel_front_full, _band_stages).  Per row, in order:
//   1. u8 -> (x-128)/128, I/Q deinterleave, 101-tap RF LPF decimating by
//      `decim` on both legs, over [iq_tail || block]
//   2. the differentiator demod, with prev_i/prev_q carried and the
//      zero-power guard
//   3. the pilot / stereo / RDS-band bank (one shared history) and the
//      mono delay
//   4. squaring, the 114 kHz carrier BPF, and the RDS delay
// New tails are the trailing samples of each stream.
//
// What bounds it on the card: the u8 read (153,600 bytes per row at mode
// 0) is the only stream from device memory that scales with the input;
// the five IF-rate outputs are 1/20 of it each in samples.  The MACs
// (~2 x 101 per IF sample for the RF legs, ~4 x 101 for the bank and the
// carrier) are float32 work the SMs do at a fraction of their rate.
// The design keeps every intermediate stream (i_ds, q_ds, fm, the RDS
// band and its square) in shared memory, so nothing but the block's
// input and the five outputs touch device memory, and loads the u8 row
// tile by tile with consecutive threads on consecutive bytes.
//
// Numerics: the normalize is done first, (x-128)/128, which is exact in
// float32 (the TPU kernel's -128*sum(h) epilogue is an MXU device that
// cancels in float32 and is not copied).  The sums run tap by tap and
// may contract into FMAs, so results match the plain torch version to
// float32 tolerance, not bitwise; iq_tail comes straight from the raw
// block and is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 256;  // RF outputs per u8 tile

struct Geometry {
  long long bs;    // u8 bytes per row (I and Q interleaved)
  int n_in;        // complex samples per row = bs / 2
  int n_out;       // IF samples = n_in / decim
  int decim;
  int k_rf;        // RF LPF taps
  int s_rf;        // k_rf - 1: RF tail in input samples
  int kb;          // band / carrier taps
  int s_b;         // kb - 1: band history
  int dly;         // kb / 2: mono and RDS delays
  int tile_in;     // kTile * decim + s_rf: input samples per tile
};

__host__ __device__ inline size_t smem_floats(const Geometry& g) {
  // taps (rf + 3 bank rows + carrier), bufA, bufB, fm_ext, I/Q tiles
  return static_cast<size_t>(g.k_rf + 4 * g.kb) +
         3 * static_cast<size_t>(g.s_b + g.n_out) + 2 * g.tile_in;
}

__global__ void __launch_bounds__(kThreads) frontend_full_kernel(
    const uint8_t* __restrict__ iq_u8, const float* __restrict__ h_rf,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    const float* __restrict__ iq_tail, const float* __restrict__ prev_i,
    const float* __restrict__ prev_q, const float* __restrict__ bank_tail,
    const float* __restrict__ mono_delay,
    const float* __restrict__ carrier_tail,
    const float* __restrict__ rds_delay, float* __restrict__ fmd,
    float* __restrict__ pilot, float* __restrict__ stereo,
    float* __restrict__ carrier, float* __restrict__ rdsdel,
    float* __restrict__ iq_tail_out, float* __restrict__ prev_i_out,
    float* __restrict__ prev_q_out, float* __restrict__ bank_tail_out,
    float* __restrict__ mono_delay_out,
    float* __restrict__ carrier_tail_out,
    float* __restrict__ rds_delay_out, Geometry g) {
  extern __shared__ float smem[];
  float* hr = smem;                      // [k_rf]
  float* hb = hr + g.k_rf;               // [3, kb]
  float* hc = hb + 3 * g.kb;             // [kb]
  float* buf_a = hc + g.kb;              // i_ds, then [carrier_tail || sq]
  float* buf_b = buf_a + g.s_b + g.n_out;  // q_ds, then the RDS band
  float* fm_ext = buf_b + g.s_b + g.n_out;  // [bank_tail || fm]
  float* tile_i = fm_ext + g.s_b + g.n_out;  // [tile_in]
  float* tile_q = tile_i + g.tile_in;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* x = iq_u8 + row * g.bs;
  const float* tail = iq_tail + row * 2 * g.s_rf;  // [2, s_rf]
  const long long ro = row * g.n_out;

  for (int j = tid; j < g.k_rf; j += kThreads) hr[j] = h_rf[j];
  for (int j = tid; j < 3 * g.kb; j += kThreads) hb[j] = h_bank[j];
  for (int j = tid; j < g.kb; j += kThreads) hc[j] = h_carrier[j];

  // ---- 1. RF LPF, both legs: y[m] = sum_j h[j] * ext[m*decim + s_rf - j]
  // with ext = [tail || x] per leg.  A tile of kTile outputs reads ext
  // indices [m0*decim, m0*decim + tile_in).
  for (int m0 = 0; m0 < g.n_out; m0 += kTile) {
    __syncthreads();  // previous tile consumed (and taps loaded)
    const long long w0 = static_cast<long long>(m0) * g.decim;
    // walk the interleaved bytes: consecutive threads, consecutive bytes
    for (int b = tid; b < 2 * g.tile_in; b += kThreads) {
      const int u = b >> 1;
      const int leg = b & 1;
      const long long w = w0 + u;     // ext index
      float v = 0.0f;
      if (w < g.s_rf) {
        v = tail[leg * g.s_rf + w];
      } else if (w - g.s_rf < g.n_in) {
        v = (static_cast<float>(x[2 * (w - g.s_rf) + leg]) - 128.0f) *
            0.0078125f;
      }
      (leg ? tile_q : tile_i)[u] = v;
    }
    __syncthreads();
    for (int i = tid; i < kTile && m0 + i < g.n_out; i += kThreads) {
      const int base = i * g.decim + g.s_rf;
      float ai = 0.0f, aq = 0.0f;
      for (int j = 0; j < g.k_rf; ++j) {
        ai += hr[j] * tile_i[base - j];
        aq += hr[j] * tile_q[base - j];
      }
      buf_a[m0 + i] = ai;
      buf_b[m0 + i] = aq;
    }
  }
  __syncthreads();

  // ---- 2. demod into fm_ext = [bank_tail || fm]
  for (int s = tid; s < g.s_b; s += kThreads)
    fm_ext[s] = bank_tail[row * g.s_b + s];
  for (int m = tid; m < g.n_out; m += kThreads) {
    const float i = buf_a[m];
    const float q = buf_b[m];
    const float ip = m ? buf_a[m - 1] : prev_i[row];
    const float qp = m ? buf_b[m - 1] : prev_q[row];
    const float power = i * i + q * q;
    const float num = i * (q - qp) - q * (i - ip);
    fm_ext[g.s_b + m] = power == 0.0f ? 0.0f : num / power;
  }
  if (tid == 0) {
    prev_i_out[row] = buf_a[g.n_out - 1];
    prev_q_out[row] = buf_b[g.n_out - 1];
  }
  for (int t = tid; t < 2 * g.s_rf; t += kThreads) {
    // next RF tail, [2, s_rf], from the raw block's last 2*s_rf bytes
    const int leg = t / g.s_rf;
    const int k = t % g.s_rf;
    iq_tail_out[row * 2 * g.s_rf + t] =
        (static_cast<float>(x[g.bs - 2 * g.s_rf + 2 * k + leg]) - 128.0f) *
        0.0078125f;
  }
  __syncthreads();  // i_ds / q_ds are dead from here on

  // ---- 3. band bank over fm, mono delay; the RDS band goes to buf_b and
  // its square to buf_a = [carrier_tail || sq]
  for (int s = tid; s < g.s_b; s += kThreads)
    buf_a[s] = carrier_tail[row * g.s_b + s];
  for (int m = tid; m < g.n_out; m += kThreads) {
    float p = 0.0f, st = 0.0f, rb = 0.0f;
    const float* f = fm_ext + m + g.s_b;
    for (int j = 0; j < g.kb; ++j) {
      const float v = f[-j];
      p += hb[j] * v;
      st += hb[g.kb + j] * v;
      rb += hb[2 * g.kb + j] * v;
    }
    pilot[ro + m] = p;
    stereo[ro + m] = st;
    buf_b[m] = rb;
    buf_a[g.s_b + m] = rb * rb;
    fmd[ro + m] = m < g.dly ? mono_delay[row * g.dly + m]
                            : fm_ext[g.s_b + m - g.dly];
  }
  for (int s = tid; s < g.s_b; s += kThreads)
    bank_tail_out[row * g.s_b + s] = fm_ext[g.n_out + s];
  for (int d = tid; d < g.dly; d += kThreads)
    mono_delay_out[row * g.dly + d] = fm_ext[g.s_b + g.n_out - g.dly + d];
  __syncthreads();

  // ---- 4. carrier BPF over the squared RDS band, RDS delay
  for (int m = tid; m < g.n_out; m += kThreads) {
    float acc = 0.0f;
    const float* sq = buf_a + m + g.s_b;
    for (int j = 0; j < g.kb; ++j) acc += hc[j] * sq[-j];
    carrier[ro + m] = acc;
    rdsdel[ro + m] = m < g.dly ? rds_delay[row * g.dly + m]
                               : buf_b[m - g.dly];
  }
  for (int s = tid; s < g.s_b; s += kThreads)
    carrier_tail_out[row * g.s_b + s] = buf_a[g.n_out + s];
  for (int d = tid; d < g.dly; d += kThreads)
    rds_delay_out[row * g.dly + d] = buf_b[g.n_out - g.dly + d];
}

}  // namespace

// Shapes (all row-major, float32 unless said): iq_u8 [c, bs] u8,
// h_rf [k_rf], h_bank [3, kb], h_carrier [kb], iq_tail [c, 2, k_rf-1],
// prev_i/prev_q [c], bank_tail [c, kb-1], mono_delay [c, kb/2],
// carrier_tail [c, kb-1], rds_delay [c, kb/2]; the five outputs
// [c, bs/2/decim] and the new tails in the shapes of the old ones.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dy4_frontend_full(
    const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
    const float* h_carrier, const float* iq_tail, const float* prev_i,
    const float* prev_q, const float* bank_tail, const float* mono_delay,
    const float* carrier_tail, const float* rds_delay, float* fmd,
    float* pilot, float* stereo, float* carrier, float* rdsdel,
    float* iq_tail_out, float* prev_i_out, float* prev_q_out,
    float* bank_tail_out, float* mono_delay_out, float* carrier_tail_out,
    float* rds_delay_out, long long c, long long bs, int decim, int k_rf,
    int kb, void* stream) {
  Geometry g;
  g.bs = bs;
  g.n_in = static_cast<int>(bs / 2);
  g.n_out = g.n_in / decim;
  g.decim = decim;
  g.k_rf = k_rf;
  g.s_rf = k_rf - 1;
  g.kb = kb;
  g.s_b = kb - 1;
  g.dly = kb / 2;
  g.tile_in = kTile * decim + g.s_rf;
  if (c <= 0) return 0;
  const size_t smem = smem_floats(g) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      frontend_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frontend_full_kernel<<<static_cast<unsigned>(c), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i, prev_q, bank_tail,
      mono_delay, carrier_tail, rds_delay, fmd, pilot, stereo, carrier,
      rdsdel, iq_tail_out, prev_i_out, prev_q_out, bank_tail_out,
      mono_delay_out, carrier_tail_out, rds_delay_out, g);
  return static_cast<int>(cudaGetLastError());
}
