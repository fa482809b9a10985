// Audio back end of every mode: stereo mix, the mono and stereo
// resamplers, and the L/R matrix, in one pass; the polyphase tile
// resampler of rational.cuh.  The rational modes 2 and 3 (U > 1, B5) and
// the decimating modes 0 and 1 (U = 1, B3) run this one kernel.
//
// Replaces dy4tpu/ops/resample_pallas.py :: fused_audio_backend_rational
// (_audio_kernel) and dy4tpu/ops/backend_pallas.py :: fused_audio_backend
// (_kernel).  The mono leg is fm_delayed, the stereo leg 2 * nco *
// stereo_band formed on chip; both run the resampler of rational.cuh with
// their carried tails; left = mono + stereo, right = mono - stereo.  The
// new tails are the last S samples of each input leg.
//
// What bounds it on the card: bytes.  A block of C = 512 reads three
// IF-rate rows a channel and writes three audio rows: 0.0211 / 0.0264 ms
// over 3.35 TB/s at modes 2 and 3 (147/800 and 147/1280 with K = 14847),
// 0.0171 / 0.0193 ms at modes 0 and 1 (D = 5 and 8, K = 101); 2 x 101
// FMAs an output come to less.
//
// What held the first designs back.  B5 (a block per (row, tile of 512
// outputs), one output a thread, 0.1415 / 0.1577 ms): every block
// gathered its 59 KB of taps with h[r + t*U], a stride-147 read in which
// each 4-byte load took its own 32-byte sector, and each tap read from
// shared memory fed only 2 FMAs.  B3 (a block per 256 outputs of a row,
// one output a thread, 0.0582 / 0.1482 ms at D = 5 / 8): a thread's
// D-strided window reads put lanes 4 apart on one bank at D = 8 (an 8-way
// conflict), three shared-memory reads fed each FMA pair, and each block
// staged its taps and window and waited at a barrier before any FMA.
//
// The design (rational.cuh): persistent blocks, one an SM, read the taps
// once, in natural order, and scatter them into shifted rows; copy warps
// load fm_delayed, nco and stereo_band once and store the mono and mixed
// stereo legs interleaved, so one 8-byte read feeds both legs, while the
// compute warps work on the item before; a compute thread owns a tuple of
// P consecutive positions (at U = 1, P consecutive outputs), which share
// each input read, and accumulates `chunk` cycles of both legs at once
// (resample_cuda._tile_plan picks P, chunk and, at U = 1, the cycle's
// tuples and their leads, which spread a warp's reads over the banks at
// even D).  Tiles are whole cycles with no halo (no filter follows); the
// resampled tile is staged in shared memory and the three outputs are
// stored coalesced.
//
// Numerics: nco * sb * 2 is the plain version's product in its order, so
// the stereo tail is exact (the mono tail is a copy); every output is one
// chain of fmaf over its taps in order from +0, whatever the plan; all
// match the plain torch version to float32 tolerance.
//
// At precision "default" / "high" (dy4tpu's mm_dtype=bf16) the kernel is
// rational_tc.cuh's tensor-core design: both legs rounded to bf16 as they
// are staged, after the mix, as dy4tpu's _kernel / _audio_kernel cast
// them before the dot, the resampler a bf16 mma.sync product with float32
// sums; at U = 1 (B3) a cycle of 8 outputs, mma_bf16.cuh's decimating
// Toeplitz product.  The tails stay float32.

#include "rational.cuh"
#include "rational_tc.cuh"

namespace {

using rational::Item;
using rational::Plan;

struct AudioIo {
  // the tensor-core design's block (rational_tc.cuh)
  static constexpr int kThreads = 512, kChains = 4, kVec = 4;

  const float *h, *h2;                     // h_audio [k]; no second filter
  const float *fmd, *sb, *nco;             // [c, n_in]
  const float *mono_tail, *stereo_tail;    // [c, s]
  float *mono, *left, *right;              // [c, m_out]
  float *mono_tail_out, *stereo_tail_out;  // [c, s]

  __device__ __forceinline__ float2 tail(long long row, int w, int s) const {
    return make_float2(mono_tail[row * s + w], stereo_tail[row * s + w]);
  }
  __device__ __forceinline__ void fetch(long long i, float& a, float& b,
                                        float& c) const {
    a = fmd[i];
    b = nco[i];
    c = sb[i];
  }
  __device__ __forceinline__ void fetch4(long long i, float4& a, float4& b,
                                         float4& c) const {
    a = *reinterpret_cast<const float4*>(fmd + i);
    b = *reinterpret_cast<const float4*>(nco + i);
    c = *reinterpret_cast<const float4*>(sb + i);
  }
  __device__ __forceinline__ bool aligned(long long i) const {
    return ((reinterpret_cast<uintptr_t>(fmd + i) |
             reinterpret_cast<uintptr_t>(nco + i) |
             reinterpret_cast<uintptr_t>(sb + i)) & 15) == 0;
  }
  __device__ __forceinline__ float2 mix(float a, float b, float c) const {
    return make_float2(a, __fmul_rn(__fmul_rn(b, c), 2.0f));
  }

  __device__ __forceinline__ void prologue(const Plan&, const Item&, float*,
                                           int) const {}

  __device__ __forceinline__ void epilogue(const Plan& p, const Item& it,
                                           const float2* xw, const float*,
                                           const float* ye, float*,
                                           int ctid) const {
    const int n = it.m1 - it.m0;
    for (int i = ctid; i < it.nrows * n; i += p.compute_threads) {
      const int r = i / n;
      const int o = i - r * n;
      const float vm = ye[2 * r * p.ystride + o];
      const float vs = ye[(2 * r + 1) * p.ystride + o];
      const long long at = (it.row0 + r) * p.m_out + it.m0 + o;
      mono[at] = vm;
      left[at] = __fadd_rn(vm, vs);
      right[at] = __fsub_rn(vm, vs);
    }
    rational::store_input_tails(p, it, xw, mono_tail_out,
                                stereo_tail_out, ctid);
  }

  // The tensor-core design (rational_tc.cuh): a row's new tails, as the
  // copy warps stage them
  __device__ __forceinline__ void put_tail(long long row, int j, int s,
                                           float2 v) const {
    mono_tail_out[row * s + j] = v.x;
    stereo_tail_out[row * s + j] = v.y;
  }

  // The tensor-core design's item: the resampler's sums staged in `ys`
  // (stream 2r + leg at ys[stream * ystride + m - m0]), then mono, left =
  // mono + stereo and right = mono - stereo of each row, 16 bytes a store
  // from its first 16-byte aligned output on.
  __device__ __forceinline__ void run_tc(const Plan& p, const Item& it,
                                         const uint16_t* win,
                                         const uint2* frag, const uint2*,
                                         const int* table, uint16_t* rb,
                                         int ctid) const {
    float* ys = reinterpret_cast<float*>(rb);
    rational_tc::resample<kChains>(
        p, it, win, frag, table, ctid, [&](int r, int m, float vm, float vs) {
          ys[2 * r * p.ystride + m - it.m0] = vm;
          ys[(2 * r + 1) * p.ystride + m - it.m0] = vs;
        });
    rational::sync_compute(p.compute_threads);
    const int n = it.m1 - it.m0;
    for (int r = 0; r < it.nrows; ++r) {
      const long long at0 = (it.row0 + r) * p.m_out + it.m0;
      const float* y0 = ys + 2 * r * p.ystride;
      const float* y1 = y0 + p.ystride;
      auto one = [&](int o) {
        mono[at0 + o] = y0[o];
        left[at0 + o] = __fadd_rn(y0[o], y1[o]);
        right[at0 + o] = __fsub_rn(y0[o], y1[o]);
      };
      const int head = static_cast<int>((4 - (at0 & 3)) & 3) < n
                           ? static_cast<int>((4 - (at0 & 3)) & 3)
                           : n;
      const int n4 = (n - head) / 4;
      for (int o = ctid; o < head; o += p.compute_threads) one(o);
      for (int v = ctid; v < n4; v += p.compute_threads) {
        const int o = head + 4 * v;
        const float4 a = make_float4(y0[o], y0[o + 1], y0[o + 2], y0[o + 3]);
        const float4 b = make_float4(y1[o], y1[o + 1], y1[o + 2], y1[o + 3]);
        *reinterpret_cast<float4*>(mono + at0 + o) = a;
        *reinterpret_cast<float4*>(left + at0 + o) = make_float4(
            __fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
            __fadd_rn(a.w, b.w));
        *reinterpret_cast<float4*>(right + at0 + o) = make_float4(
            __fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
            __fsub_rn(a.w, b.w));
      }
      for (int o = head + 4 * n4 + ctid; o < n; o += p.compute_threads)
        one(o);
    }
  }
};

// The kernels: a persistent block of the tile resampler, the float32 walk
// (rational.cuh) and the tensor-core design (rational_tc.cuh).
template <int P, int QT>
__global__ void __launch_bounds__(rational::kMaxThreads, 1)
    audio_rational_kernel(AudioIo io, Plan p) {
  rational::run<AudioIo, P, QT>(io, p);
}

__global__ void __launch_bounds__(AudioIo::kThreads, 1)
    audio_rational_kernel_tc(AudioIo io, Plan p) {
  rational_tc::run(io, p);
}

struct Kernel {
  template <int P, int QT>
  static auto fn() {
    return audio_rational_kernel<P, QT>;
  }
  static auto tc() { return audio_rational_kernel_tc; }
};

}  // namespace

// fmd, sb, nco: [c, n_in]; h: [k]; tails [c, (k-1)/up]; outputs
// [c, n_in*up/down] and the new tails; then resample_cuda._tile_plan's
// plan.  The float32 walk (precision "highest").  Returns
// cudaGetLastError() after the launch (0 = launched;
// cudaErrorInvalidValue, launching nothing, for a plan the kernel cannot
// run).
extern "C" int dy4_audio_rational(
    const float* fmd, const float* sb, const float* nco, const float* h,
    const float* mono_tail, const float* stereo_tail, float* mono,
    float* left, float* right, float* mono_tail_out, float* stereo_tail_out,
    long long c, int n_in, int up, int down, int k, int span, int dinv,
    int phases, int tmul, int tinv, int lead_group, int lead_mod, int lx,
    int guard, int rows, int cycles, int n_tiles, int halo_cycles,
    int window, int ystride, int yhead, int chunk, int groups,
    int compute_threads, int threads, int ctas, int items, int smem,
    void* stream) {
  const Plan p = rational::make_plan(
      c, n_in, up, down, k, 0, span, dinv, phases, tmul, tinv, lead_group,
      lead_mod, lx, guard, rows, cycles, n_tiles, halo_cycles, window,
      ystride, yhead, chunk, groups, compute_threads, threads, ctas, items,
      smem);
  const AudioIo io{h,    nullptr, fmd,   sb,    nco,           mono_tail,
                   stereo_tail, mono, left, right, mono_tail_out,
                   stereo_tail_out};
  return rational::launch<Kernel>(io, p, stream);
}

// The tensor-core design (precision "default" / "high"; the kernel rounds
// h itself): the arguments of dy4_audio_rational, then
// resample_cuda._tc_plan's plan (k2 = 0, rlen = 0).
extern "C" int dy4_audio_rational_tc(
    const float* fmd, const float* sb, const float* nco, const float* h,
    const float* mono_tail, const float* stereo_tail, float* mono,
    float* left, float* right, float* mono_tail_out, float* stereo_tail_out,
    long long c, int n_in, int up, int down, int k, int span, int dinv,
    int ks, int lead, int pad, int reach, int slen, int rows, int cycles,
    int n_tiles, int halo_cycles, int rlen, int ystride, int bufs,
    int compute_threads, int threads, int ctas, int items, int smem,
    void* stream) {
  const Plan p = rational_tc::make_plan(
      c, n_in, up, down, k, 0, span, dinv, ks, lead, pad, reach, slen, rows,
      cycles, n_tiles, halo_cycles, rlen, ystride, bufs, compute_threads,
      threads, ctas, items, smem);
  const AudioIo io{h,    nullptr, fmd,   sb,    nco,           mono_tail,
                   stereo_tail, mono, left, right, mono_tail_out,
                   stereo_tail_out};
  return rational_tc::launch<Kernel>(io, p, stream);
}

// Thread blocks an SM of an instantiation (dy4_rds_backend_blocks).
extern "C" int dy4_audio_rational_blocks(int tc, int phases, int chunk,
                                         int threads, long long smem) {
  return rational::blocks<Kernel>(tc, phases, chunk, threads, smem);
}
