// RDS back end: quadrature mix, rational U/D resampler with its 3 kHz LPF,
// RRC matched filter, for the I and Q legs of C rows with four tails
// carried; the polyphase tile resampler of rational.cuh.
//
// Replaces dy4tpu/ops/resample_pallas.py :: fused_rds_backend
// (_rds_kernel).  Per row and leg:
//   1. x_ext = [lpf_tail || nco * rds_delayed]           (S + N samples)
//   2. y[m] = the rational resampler of rational.cuh over x_ext
//   3. bb[m] = sum_j h_rrc[j] * [rrc_tail || y][m + S2 - j], S2 = K2-1
// The new LPF tail is the last S mixed samples, the new RRC tail the last
// S2 resampled ones.
//
// What bounds it on the card: bytes.  A block of C = 512 reads three
// IF-rate rows a channel and writes the baseband, 0.0161 ms at mode 0
// (19/120, K = 1919, 7680 -> 1216) and 0.0213 ms at mode 2 (171/640,
// K = 17271, 9600 -> 2565) over 3.35 TB/s; its 2 x 101 FMAs an output
// twice (resampler, RRC) come to less.
//
// What held the first design (one block per (row, leg), 256 threads, the
// whole row in shared memory) to 0.1132 / 0.3760 ms: at mode 2 a block
// took about 119 KB, so one block of 8 warps an SM in about 7.8 waves;
// every block staged all 69 KB of taps again (71 MB of L2 reads for 59 MB
// of input); the I and Q legs of a row were two blocks that each read rds
// again; the flipped tap index strided by U within a thread and differed
// from thread to thread (bank conflicts); and the RRC ran only after the
// whole row's resampler, behind a __syncthreads.
//
// The design (rational.cuh): persistent blocks, one an SM, stage the taps
// once; copy warps load rds, nco_i and nco_q once and store the I and Q
// legs mixed and interleaved, so one 8-byte read feeds both legs; a
// compute thread owns a tuple of P consecutive positions, whose tap rows
// are shifted to share each input read, and accumulates `chunk` cycles
// of both legs at once (resample_cuda._tile_plan picks P and chunk: 4 x 1
// at mode 0, 3 x 2 at mode 2).  The RRC runs on the item's tile in shared
// memory right after the resampler: tile 0 of a row reads the carried RRC
// tail, every other tile recomputes a halo of whole cycles (at least
// K2 - 1 outputs) before its first output, and since an output's sum
// does not depend on the plan the halo equals what its own tile computes,
// bit for bit.  A thread takes kRrcGroup = 9 consecutive outputs of one
// leg (odd, so the warp's reads fall on distinct banks) in a register
// window, the RRC taps a shared-memory broadcast; each output's sum is
// two chains, taps [0, 54) and [54, 101), on threads of different warps
// (twice the threads a latency-bound loop had with one chain), added
// after a barrier; the outputs go through a staged tile to coalesced
// stores.
//
// Numerics: nco_i * rds and nco_q * rds are the plain version's products,
// so the LPF tails are exact; each half of the RRC sum runs its taps in
// order as one chain of fmaf, and the halves are added in one order, so
// the baseband and the RRC tails do not depend on the plan either.  All
// match the plain torch version to float32 tolerance.
//
// At precision "default" / "high" (dy4tpu's mm_dtype=bf16, as its
// _rds_kernel casts its operands) the kernel is rational_tc.cuh's
// tensor-core design: the resampler and the RRC as bf16 mma.sync products
// with float32 sums, the mixed legs rounded to bf16 as they are staged,
// the resampled stream (the carried RRC tail or the halo before it too)
// rounded before the RRC; every tail stays float32.

#include "rational.cuh"
#include "rational_tc.cuh"

namespace {

using rational::Item;
using rational::kRrcGroup;
using rational::Plan;

// The RRC sum of kRrcGroup consecutive outputs y[g], g < G, over the taps
// [j_begin, j_end) (j_begin a multiple of G), each output one chain of
// fmaf in tap order from +0.  win[(g - j) mod G] holds y[g - j] at tap j;
// whole turns of G taps read theirs before their FMAs, the last one tap
// by tap.
__device__ __forceinline__ void rrc_chain(const float* y, const float* hr,
                                          int j_begin, int j_end,
                                          float (&acc)[kRrcGroup]) {
  constexpr int G = kRrcGroup;
  float win[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] = 0.0f;
    win[g] = y[g - j_begin];
  }
  int j0 = j_begin;
  for (; j0 + G < j_end; j0 += G) {
    float hv[G], yn[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      hv[u] = hr[j0 + u];
      yn[u] = y[-(j0 + u) - 1];
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g] = __fmaf_rn(hv[u], win[(g - u + G) % G], acc[g]);
      win[(G - 1 - u) % G] = yn[u];
    }
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    if (j0 + u < j_end) {
      const float hv = hr[j0 + u];
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g] = __fmaf_rn(hv, win[(g - u + G) % G], acc[g]);
      if (j0 + u + 1 < j_end) win[(G - 1 - u) % G] = y[-(j0 + u) - 1];
    }
  }
}

// Where an output's RRC sum splits into two chains (on two threads, added
// after): the whole turns of G taps nearest half the taps, at most all.
__device__ __forceinline__ int rrc_split(int k2) {
  const int s = ((k2 + 1) / 2 + kRrcGroup - 1) / kRrcGroup * kRrcGroup;
  return s < k2 ? s : k2;
}

struct RdsIo {
  // the tensor-core design's block (rational_tc.cuh)
  static constexpr int kThreads = 1024, kChains = 2, kVec = 2;

  const float *h, *h2;                     // h_lpf [k], h_rrc [k2]
  const float *rds, *nco_i, *nco_q;        // [c, n_in]
  const float *lpf_i, *lpf_q;              // [c, s]
  const float *rrc_i, *rrc_q;              // [c, k2 - 1]
  float *bb_i, *bb_q;                      // [c, m_out]
  float *lpf_i_out, *lpf_q_out, *rrc_i_out, *rrc_q_out;

  __device__ __forceinline__ float2 tail(long long row, int w, int s) const {
    return make_float2(lpf_i[row * s + w], lpf_q[row * s + w]);
  }
  __device__ __forceinline__ void fetch(long long i, float& a, float& b,
                                        float& c) const {
    a = rds[i];
    b = nco_i[i];
    c = nco_q[i];
  }
  __device__ __forceinline__ void fetch4(long long i, float4& a, float4& b,
                                         float4& c) const {
    a = *reinterpret_cast<const float4*>(rds + i);
    b = *reinterpret_cast<const float4*>(nco_i + i);
    c = *reinterpret_cast<const float4*>(nco_q + i);
  }
  __device__ __forceinline__ bool aligned(long long i) const {
    return ((reinterpret_cast<uintptr_t>(rds + i) |
             reinterpret_cast<uintptr_t>(nco_i + i) |
             reinterpret_cast<uintptr_t>(nco_q + i)) & 15) == 0;
  }
  __device__ __forceinline__ float2 mix(float a, float b, float c) const {
    return make_float2(__fmul_rn(b, a), __fmul_rn(c, a));
  }

  // tile 0 of a row: the carried RRC tail before the tile
  __device__ __forceinline__ void prologue(const Plan& p, const Item& it,
                                           float* ye, int ctid) const {
    if (it.tile) return;
    const int s2 = p.k2 - 1;
    for (int i = ctid; i < 2 * it.nrows * s2; i += p.compute_threads) {
      const int st = i / s2;
      const int j = i - st * s2;
      const long long row = it.row0 + (st >> 1);
      ye[st * p.ystride + p.yhead - s2 + j] =
          (st & 1 ? rrc_q : rrc_i)[row * s2 + j];
    }
  }

  // the new RRC tail: this tile's outputs among the row's last s2, from
  // the float32 stream
  __device__ __forceinline__ void store_rrc_tails(const Plan& p,
                                                  const Item& it,
                                                  const float* ye,
                                                  int ctid) const {
    const int s2 = p.k2 - 1;
    const int lo = it.m0 > p.m_out - s2 ? it.m0 : p.m_out - s2;
    for (int i = ctid; i < 2 * it.nrows * (it.m1 - lo);
         i += p.compute_threads) {
      const int st = i / (it.m1 - lo);
      const int m = lo + i - st * (it.m1 - lo);
      const long long row = it.row0 + (st >> 1);
      (st & 1 ? rrc_q_out : rrc_i_out)[row * s2 + m - (p.m_out - s2)] =
          ye[st * p.ystride + p.yhead + m - it.m0];
    }
  }

  __device__ __forceinline__ void epilogue(const Plan& p, const Item& it,
                                           const float2* xw, const float* hr,
                                           float* ye, float* bb,
                                           int ctid) const {
    constexpr int G = kRrcGroup;
    const int n = it.m1 - it.m0;
    const int ng = (n + G - 1) / G;
    const int tstride = rational::r4(p.cycles * p.span);
    const int split = rrc_split(p.k2);
    const int half = 2 * it.nrows * ng;    // groups of one half
    float* bb2 = bb + 2 * p.rows * tstride;
    store_rrc_tails(p, it, ye, ctid);
    for (int f = ctid; f < 2 * half; f += p.compute_threads) {
      const bool second = f >= half;
      const int g0 = second ? f - half : f;
      const int st = g0 / ng;
      const int o0 = (g0 - st * ng) * G;
      const float* y = ye + st * p.ystride + p.yhead + o0;
      float acc[G];
      if (second)
        rrc_chain(y, hr, split, p.k2, acc);
      else
        rrc_chain(y, hr, 0, split, acc);
      float* out = (second ? bb2 : bb) + st * tstride + o0;
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (o0 + g < n) out[g] = acc[g];
    }
    rational::sync_compute(p.compute_threads);

    for (int i = ctid; i < 2 * it.nrows * n; i += p.compute_threads) {
      const int st = i / n;
      const int o = i - st * n;
      const long long row = it.row0 + (st >> 1);
      (st & 1 ? bb_q : bb_i)[row * p.m_out + it.m0 + o] =
          __fadd_rn(bb[st * tstride + o], bb2[st * tstride + o]);
    }
    rational::store_input_tails(p, it, xw, lpf_i_out, lpf_q_out,
                                ctid);
  }

  // The tensor-core design (rational_tc.cuh): a row's new LPF tail, as
  // the copy warps stage it
  __device__ __forceinline__ void put_tail(long long row, int j, int s,
                                           float2 v) const {
    lpf_i_out[row * s + j] = v.x;
    lpf_q_out[row * s + j] = v.y;
  }

  // The tensor-core design's item for compute thread `ctid`: the resampler,
  // its stream rounded into the RRC input rb (the carried RRC tail below
  // it in tile 0, loaded before the MMAs) and its row's last S2 outputs to
  // the new RRC tail, then the RRC into bb_i / bb_q.
  __device__ __forceinline__ void run_tc(const Plan& p, const Item& it,
                                         const uint16_t* win,
                                         const uint2* frag, const uint2* frr,
                                         const int* table, uint16_t* rb,
                                         int ctid) const {
    constexpr int kTail = 2;                  // tail loads a thread issues
    const int s2 = p.k2 - 1;
    const int nct = p.compute_threads;
    const int e0 = rational_tc::rrc_span(p, it).e0;
    const int nt = it.tile ? 0 : 2 * it.nrows * s2;
    auto tail_at = [&](int i) {
      const int st = i / s2;
      return (st & 1 ? rrc_q : rrc_i) + (it.row0 + (st >> 1)) * s2 + i -
             st * s2;
    };
    float tv[kTail];
#pragma unroll
    for (int j = 0; j < kTail; ++j)
      if (ctid + j * nct < nt) tv[j] = *tail_at(ctid + j * nct);
    rational_tc::resample<kChains>(
        p, it, win, frag, table, ctid, [&](int r, int m, float v0, float v1) {
          const int q = m - e0 + s2;
          if (q >= 0) {
            rb[2 * r * p.rlen + q] = static_cast<uint16_t>(tc::bf16_bits(v0));
            rb[(2 * r + 1) * p.rlen + q] =
                static_cast<uint16_t>(tc::bf16_bits(v1));
          }
          if (m >= it.m0 && m >= p.m_out - s2) {
            const long long at = (it.row0 + r) * s2 + m - (p.m_out - s2);
            rrc_i_out[at] = v0;
            rrc_q_out[at] = v1;
          }
        });
    auto put = [&](int i, float v) {
      const int st = i / s2;
      rb[st * p.rlen + i - st * s2] = static_cast<uint16_t>(tc::bf16_bits(v));
    };
#pragma unroll
    for (int j = 0; j < kTail; ++j)
      if (ctid + j * nct < nt) put(ctid + j * nct, tv[j]);
    for (int i = ctid + kTail * nct; i < nt; i += nct) put(i, *tail_at(i));
    rational_tc::rrc<kChains>(p, it, rb, frr, ctid, [&](int st) {
      return (st & 1 ? bb_q : bb_i) + (it.row0 + (st >> 1)) * p.m_out;
    });
  }
};

// The kernels: a persistent block of the tile resampler, the float32 walk
// (rational.cuh) and the tensor-core design (rational_tc.cuh).
template <int P, int QT>
__global__ void __launch_bounds__(rational::kMaxThreads, 1)
    rds_backend_kernel(RdsIo io, Plan p) {
  rational::run<RdsIo, P, QT>(io, p);
}

__global__ void __launch_bounds__(RdsIo::kThreads, 1)
    rds_backend_kernel_tc(RdsIo io, Plan p) {
  rational_tc::run(io, p);
}

struct Kernel {
  template <int P, int QT>
  static auto fn() {
    return rds_backend_kernel<P, QT>;
  }
  static auto tc() { return rds_backend_kernel_tc; }
};

}  // namespace

// rds, nco_i, nco_q: [c, n_in]; h_lpf [k]; h_rrc [k2]; lpf tails
// [c, (k-1)/up]; rrc tails [c, k2-1]; bb_i/bb_q [c, n_in*up/down] and the
// new tails; then resample_cuda._tile_plan's plan.  The float32 walk
// (precision "highest").  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, launching nothing, for a plan the kernel cannot
// run).
extern "C" int dy4_rds_backend(
    const float* rds, const float* nco_i, const float* nco_q,
    const float* h_lpf, const float* h_rrc, const float* lpf_tail_i,
    const float* lpf_tail_q, const float* rrc_tail_i,
    const float* rrc_tail_q, float* bb_i, float* bb_q,
    float* lpf_tail_i_out, float* lpf_tail_q_out, float* rrc_tail_i_out,
    float* rrc_tail_q_out, long long c, int n_in, int up, int down, int k,
    int k2, int span, int dinv, int phases, int tmul, int tinv,
    int lead_group, int lead_mod, int lx, int guard, int rows, int cycles,
    int n_tiles, int halo_cycles, int window, int ystride, int yhead,
    int chunk, int groups, int compute_threads, int threads, int ctas,
    int items, int smem, void* stream) {
  const Plan p = rational::make_plan(
      c, n_in, up, down, k, k2, span, dinv, phases, tmul, tinv, lead_group,
      lead_mod, lx, guard, rows, cycles, n_tiles, halo_cycles, window,
      ystride, yhead, chunk, groups, compute_threads, threads, ctas, items,
      smem);
  if (k2 < 1 || p.m_out < k2 - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RdsIo io{h_lpf,          h_rrc,          rds,        nco_i,
                 nco_q,          lpf_tail_i,     lpf_tail_q, rrc_tail_i,
                 rrc_tail_q,     bb_i,           bb_q,       lpf_tail_i_out,
                 lpf_tail_q_out, rrc_tail_i_out, rrc_tail_q_out};
  return rational::launch<Kernel>(io, p, stream);
}

// The tensor-core design (precision "default" / "high"; the kernel rounds
// h_lpf and h_rrc itself): the arguments of dy4_rds_backend, then
// resample_cuda._tc_plan's plan (ystride = 0).
extern "C" int dy4_rds_backend_tc(
    const float* rds, const float* nco_i, const float* nco_q,
    const float* h_lpf, const float* h_rrc, const float* lpf_tail_i,
    const float* lpf_tail_q, const float* rrc_tail_i,
    const float* rrc_tail_q, float* bb_i, float* bb_q,
    float* lpf_tail_i_out, float* lpf_tail_q_out, float* rrc_tail_i_out,
    float* rrc_tail_q_out, long long c, int n_in, int up, int down, int k,
    int k2, int span, int dinv, int ks, int lead, int pad, int reach, int slen,
    int rows, int cycles, int n_tiles, int halo_cycles, int rlen,
    int ystride, int bufs, int compute_threads, int threads, int ctas,
    int items, int smem, void* stream) {
  const Plan p = rational_tc::make_plan(
      c, n_in, up, down, k, k2, span, dinv, ks, lead, pad, reach, slen, rows,
      cycles, n_tiles, halo_cycles, rlen, ystride, bufs, compute_threads,
      threads, ctas, items, smem);
  if (k2 < 1 || p.m_out < k2 - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RdsIo io{h_lpf,          h_rrc,          rds,        nco_i,
                 nco_q,          lpf_tail_i,     lpf_tail_q, rrc_tail_i,
                 rrc_tail_q,     bb_i,           bb_q,       lpf_tail_i_out,
                 lpf_tail_q_out, rrc_tail_i_out, rrc_tail_q_out};
  return rational_tc::launch<Kernel>(io, p, stream);
}

// Thread blocks an SM of the float32 walk's (phases, chunk) instantiation,
// or of the tensor-core design where tc != 0, at `threads` threads and
// `smem` bytes of dynamic shared memory, as the card's occupancy
// calculator counts them; a negative cudaError on failure.  For reports.
extern "C" int dy4_rds_backend_blocks(int tc, int phases, int chunk,
                                      int threads, long long smem) {
  return rational::blocks<Kernel>(tc, phases, chunk, threads, smem);
}
