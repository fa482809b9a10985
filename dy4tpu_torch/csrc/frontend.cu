// The whole LTI front half of one receiver block: one thread block per
// channel row.  Two kernels share every stage after the FM demod's input.
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
// B6 frontend_if_kernel replaces fused_frontend_if (_kernel_front_if): its
// stage 1 reads float32 IF I/Q rows (a channelizer's output, already band-
// limited and decimated) instead of running the u8 read and the RF LPF;
// stages 2-4 are the same device routine, band_stages<kRds>.  Both kernels
// are templated on RDS: without it the bank has two rows, stage 4 is
// skipped, and neither the carrier taps nor the RDS tails and outputs are
// touched (their pointers may be null).  New tails are the trailing
// samples of each stream.
//
// What bounds it on the card: for B1 the u8 read (153,600 bytes per row at
// mode 0) is the only stream from device memory that scales with the
// input; the IF-rate outputs are 1/20 of it each in samples.  The MACs
// (~2 x 101 per IF sample for the RF legs, ~4 x 101 for the bank and the
// carrier) are float32 work the SMs do at a fraction of their rate.  B6
// reads two float32 IF rows and writes up to five, so it moves less than
// B1 and does no RF MACs.  The design keeps every intermediate stream
// (i_ds, q_ds, fm, the RDS band and its square) in shared memory, so
// nothing but the block's input and the outputs touch device memory, and
// loads the u8 row tile by tile with consecutive threads on consecutive
// bytes.  A whole row lives in shared memory (95 KB for B6 and 117 KB
// for B1 at mode 0, 166 KB for B1 at mode 3), so one block runs per SM;
// the wrappers check the 227 KB ceiling before a launch.
//
// Numerics: the normalize is done first, (x-128)/128, which is exact in
// float32 (the TPU kernel's -128*sum(h) epilogue is an MXU device that
// cancels in float32 and is not copied).  The sums run tap by tap and
// may contract into FMAs, so results match the plain torch version to
// float32 tolerance, not bitwise; iq_tail comes straight from the raw
// block, and B6's prev_i/prev_q straight from its input, so both are
// exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 256;  // RF outputs per u8 tile

struct Geometry {
  long long bs;    // u8 bytes per row (I and Q interleaved); 2*n_out for B6
  int n_in;        // complex samples per row = bs / 2
  int n_out;       // IF samples = n_in / decim
  int decim;
  int k_rf;        // RF LPF taps; 0 for the IF entry (no RF stage)
  int s_rf;        // k_rf - 1: RF tail in input samples
  int kb;          // band / carrier taps
  int s_b;         // kb - 1: band history
  int dly;         // kb / 2: mono and RDS delays
  int tile_in;     // kTile * decim + s_rf: input samples per tile
};

Geometry make_geometry(long long bs, int decim, int k_rf, int kb) {
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
  g.tile_in = k_rf ? kTile * decim + g.s_rf : 0;
  return g;
}

// Shared-memory layout, in floats, in this order:
//   hr [k_rf]          RF taps (B1 only)
//   hb [nb, kb]        bank taps, nb = 3 with RDS, else 2
//   hc [kb]            carrier taps (RDS only)
//   buf_a [a_len]      i_ds; then [carrier_tail || squared RDS band]
//   buf_b [b_len]      q_ds; then the RDS band
//   fm_ext [s_b+n_out] [bank_tail || fm]
//   tile_i, tile_q [tile_in] the u8 tile of each leg (B1 only)
__host__ __device__ inline int bank_rows(bool rds) { return rds ? 3 : 2; }
__host__ __device__ inline int buf_a_len(const Geometry& g, bool rds) {
  return rds ? g.s_b + g.n_out : g.n_out;
}

__host__ __device__ inline size_t smem_floats(const Geometry& g, bool rds) {
  return static_cast<size_t>(g.k_rf) + (bank_rows(rds) + rds) * g.kb +
         2 * static_cast<size_t>(buf_a_len(g, rds)) + g.s_b + g.n_out +
         2 * static_cast<size_t>(g.tile_in);
}

struct Smem {
  float* hr;
  float* hb;
  float* hc;
  float* buf_a;
  float* buf_b;
  float* fm_ext;
  float* tile_i;
  float* tile_q;
};

template <bool kRds>
__device__ Smem carve(float* smem, const Geometry& g) {
  Smem s;
  s.hr = smem;
  s.hb = s.hr + g.k_rf;
  s.hc = s.hb + bank_rows(kRds) * g.kb;
  s.buf_a = s.hc + (kRds ? g.kb : 0);
  s.buf_b = s.buf_a + buf_a_len(g, kRds);
  s.fm_ext = s.buf_b + buf_a_len(g, kRds);
  s.tile_i = s.fm_ext + g.s_b + g.n_out;
  s.tile_q = s.tile_i + g.tile_in;
  return s;
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
  for (int j = tid; j < nb * g.kb; j += kThreads) s.hb[j] = h_bank[j];
  if (h_carrier)
    for (int j = tid; j < g.kb; j += kThreads) s.hc[j] = h_carrier[j];
}

// Stages 2-4 of one row.  On entry buf_a[0, n_out) holds the row's I and
// buf_b[0, n_out) its Q at the IF rate, visible to every thread, and the
// bank (and carrier) taps are in shared memory.
template <bool kRds>
__device__ void band_stages(const Smem& s, const Geometry& g, long long row,
                            int tid, const BandIO& io) {
  float* buf_a = s.buf_a;
  float* buf_b = s.buf_b;
  float* fm_ext = s.fm_ext;
  const long long ro = row * g.n_out;

  // ---- 2. demod into fm_ext = [bank_tail || fm]
  for (int k = tid; k < g.s_b; k += kThreads)
    fm_ext[k] = io.bank_tail[row * g.s_b + k];
  for (int m = tid; m < g.n_out; m += kThreads) {
    const float i = buf_a[m];
    const float q = buf_b[m];
    const float ip = m ? buf_a[m - 1] : io.prev_i[row];
    const float qp = m ? buf_b[m - 1] : io.prev_q[row];
    const float power = i * i + q * q;
    const float num = i * (q - qp) - q * (i - ip);
    fm_ext[g.s_b + m] = power == 0.0f ? 0.0f : num / power;
  }
  if (tid == 0) {
    io.prev_i_out[row] = buf_a[g.n_out - 1];
    io.prev_q_out[row] = buf_b[g.n_out - 1];
  }
  __syncthreads();  // i / q are dead from here on

  // ---- 3. band bank over fm, mono delay; with RDS the RDS band goes to
  // buf_b and its square to buf_a = [carrier_tail || sq]
  if (kRds)
    for (int k = tid; k < g.s_b; k += kThreads)
      buf_a[k] = io.carrier_tail[row * g.s_b + k];
  const float* hb = s.hb;
  for (int m = tid; m < g.n_out; m += kThreads) {
    float p = 0.0f, st = 0.0f, rb = 0.0f;
    const float* f = fm_ext + m + g.s_b;
    for (int j = 0; j < g.kb; ++j) {
      const float v = f[-j];
      p += hb[j] * v;
      st += hb[g.kb + j] * v;
      if (kRds) rb += hb[2 * g.kb + j] * v;
    }
    io.pilot[ro + m] = p;
    io.stereo[ro + m] = st;
    if (kRds) {
      buf_b[m] = rb;
      buf_a[g.s_b + m] = rb * rb;
    }
    io.fmd[ro + m] = m < g.dly ? io.mono_delay[row * g.dly + m]
                               : fm_ext[g.s_b + m - g.dly];
  }
  for (int k = tid; k < g.s_b; k += kThreads)
    io.bank_tail_out[row * g.s_b + k] = fm_ext[g.n_out + k];
  for (int d = tid; d < g.dly; d += kThreads)
    io.mono_delay_out[row * g.dly + d] =
        fm_ext[g.s_b + g.n_out - g.dly + d];
  if (!kRds) return;
  __syncthreads();

  // ---- 4. carrier BPF over the squared RDS band, RDS delay
  const float* hc = s.hc;
  for (int m = tid; m < g.n_out; m += kThreads) {
    float acc = 0.0f;
    const float* sq = buf_a + m + g.s_b;
    for (int j = 0; j < g.kb; ++j) acc += hc[j] * sq[-j];
    io.carrier[ro + m] = acc;
    io.rdsdel[ro + m] = m < g.dly ? io.rds_delay[row * g.dly + m]
                                  : buf_b[m - g.dly];
  }
  for (int k = tid; k < g.s_b; k += kThreads)
    io.carrier_tail_out[row * g.s_b + k] = buf_a[g.n_out + k];
  for (int d = tid; d < g.dly; d += kThreads)
    io.rds_delay_out[row * g.dly + d] = buf_b[g.n_out - g.dly + d];
}

template <bool kRds>
__global__ void __launch_bounds__(kThreads) frontend_full_kernel(
    const uint8_t* __restrict__ iq_u8, const float* __restrict__ h_rf,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    const float* __restrict__ iq_tail, float* __restrict__ iq_tail_out,
    BandIO io, Geometry g) {
  extern __shared__ float smem[];
  const Smem s = carve<kRds>(smem, g);
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* x = iq_u8 + row * g.bs;
  const float* tail = iq_tail + row * 2 * g.s_rf;  // [2, s_rf]

  for (int j = tid; j < g.k_rf; j += kThreads) s.hr[j] = h_rf[j];
  load_taps(s, g, h_bank, kRds ? h_carrier : nullptr, bank_rows(kRds), tid);

  // ---- 1. RF LPF, both legs: y[m] = sum_j h[j] * ext[m*decim + s_rf - j]
  // with ext = [tail || x] per leg.  A tile of kTile outputs reads ext
  // indices [m0*decim, m0*decim + tile_in).  i_ds goes to buf_a, q_ds to
  // buf_b.
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
      (leg ? s.tile_q : s.tile_i)[u] = v;
    }
    __syncthreads();
    for (int i = tid; i < kTile && m0 + i < g.n_out; i += kThreads) {
      const int base = i * g.decim + g.s_rf;
      float ai = 0.0f, aq = 0.0f;
      for (int j = 0; j < g.k_rf; ++j) {
        ai += s.hr[j] * s.tile_i[base - j];
        aq += s.hr[j] * s.tile_q[base - j];
      }
      s.buf_a[m0 + i] = ai;
      s.buf_b[m0 + i] = aq;
    }
  }
  for (int t = tid; t < 2 * g.s_rf; t += kThreads) {
    // next RF tail, [2, s_rf], from the raw block's last 2*s_rf bytes
    const int leg = t / g.s_rf;
    const int k = t % g.s_rf;
    iq_tail_out[row * 2 * g.s_rf + t] =
        (static_cast<float>(x[g.bs - 2 * g.s_rf + 2 * k + leg]) - 128.0f) *
        0.0078125f;
  }
  __syncthreads();
  band_stages<kRds>(s, g, row, tid, io);
}

template <bool kRds>
__global__ void __launch_bounds__(kThreads) frontend_if_kernel(
    const float* __restrict__ i_if, const float* __restrict__ q_if,
    const float* __restrict__ h_bank, const float* __restrict__ h_carrier,
    BandIO io, Geometry g) {
  extern __shared__ float smem[];
  const Smem s = carve<kRds>(smem, g);
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ro = row * g.n_out;

  load_taps(s, g, h_bank, kRds ? h_carrier : nullptr, bank_rows(kRds), tid);
  // ---- 1. the IF I/Q rows into buf_a / buf_b
  for (int m = tid; m < g.n_out; m += kThreads) {
    s.buf_a[m] = i_if[ro + m];
    s.buf_b[m] = q_if[ro + m];
  }
  __syncthreads();
  band_stages<kRds>(s, g, row, tid, io);
}

template <bool kRds>
int launch_full(const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
                const float* h_carrier, const float* iq_tail,
                float* iq_tail_out, const BandIO& io, const Geometry& g,
                long long c, cudaStream_t stream) {
  const size_t smem = smem_floats(g, kRds) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      frontend_full_kernel<kRds>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frontend_full_kernel<kRds><<<static_cast<unsigned>(c), kThreads, smem,
                               stream>>>(iq_u8, h_rf, h_bank, h_carrier,
                                         iq_tail, iq_tail_out, io, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRds>
int launch_if(const float* i_if, const float* q_if, const float* h_bank,
              const float* h_carrier, const BandIO& io, const Geometry& g,
              long long c, cudaStream_t stream) {
  const size_t smem = smem_floats(g, kRds) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      frontend_if_kernel<kRds>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frontend_if_kernel<kRds><<<static_cast<unsigned>(c), kThreads, smem,
                             stream>>>(i_if, q_if, h_bank, h_carrier, io, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes: B1 for a row of
// n_in complex samples decimated by `decim` through k_rf RF taps, or B6
// (k_rf = 0, decim = 1) for a row of n_in IF samples.  The wrappers check
// it against the card's 227 KB before a launch.
extern "C" long long dy4_frontend_smem(int n_in, int decim, int k_rf, int kb,
                                       int rds) {
  const Geometry g = make_geometry(2LL * n_in, decim, k_rf, kb);
  return static_cast<long long>(smem_floats(g, rds != 0) * sizeof(float));
}

// B1.  Shapes (all row-major, float32 unless said): iq_u8 [c, bs] u8,
// h_rf [k_rf], h_bank [nb, kb] (nb >= 3 with rds, >= 2 without; only the
// first rows are read), h_carrier [kb], iq_tail [c, 2, k_rf-1],
// prev_i/prev_q [c], bank_tail [c, kb-1], mono_delay [c, kb/2],
// carrier_tail [c, kb-1], rds_delay [c, kb/2]; the five outputs
// [c, bs/2/decim] and the new tails in the shapes of the old ones.  With
// rds = 0, h_carrier, carrier_tail, rds_delay, carrier, rdsdel and their
// new tails are not touched and may be null.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int dy4_frontend_full(
    const uint8_t* iq_u8, const float* h_rf, const float* h_bank,
    const float* h_carrier, const float* iq_tail, const float* prev_i,
    const float* prev_q, const float* bank_tail, const float* mono_delay,
    const float* carrier_tail, const float* rds_delay, float* fmd,
    float* pilot, float* stereo, float* carrier, float* rdsdel,
    float* iq_tail_out, float* prev_i_out, float* prev_q_out,
    float* bank_tail_out, float* mono_delay_out, float* carrier_tail_out,
    float* rds_delay_out, long long c, long long bs, int decim, int k_rf,
    int kb, int rds, void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(bs, decim, k_rf, kb);
  const BandIO io{prev_i, prev_q, bank_tail, mono_delay, carrier_tail,
                  rds_delay, fmd, pilot, stereo, carrier, rdsdel,
                  prev_i_out, prev_q_out, bank_tail_out, mono_delay_out,
                  carrier_tail_out, rds_delay_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rds ? launch_full<true>(iq_u8, h_rf, h_bank, h_carrier, iq_tail,
                                 iq_tail_out, io, g, c, st)
             : launch_full<false>(iq_u8, h_rf, h_bank, h_carrier, iq_tail,
                                  iq_tail_out, io, g, c, st);
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
    long long c, int n_out, int kb, int rds, void* stream) {
  if (c <= 0) return 0;
  const Geometry g = make_geometry(2LL * n_out, 1, 0, kb);
  const BandIO io{prev_i, prev_q, bank_tail, mono_delay, carrier_tail,
                  rds_delay, fmd, pilot, stereo, carrier, rdsdel,
                  prev_i_out, prev_q_out, bank_tail_out, mono_delay_out,
                  carrier_tail_out, rds_delay_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rds ? launch_if<true>(i_if, q_if, h_bank, h_carrier, io, g, c, st)
             : launch_if<false>(i_if, q_if, h_bank, h_carrier, io, g, c, st);
}
