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
// match the plain torch version to float32 tolerance.  With `bf16` (dy4tpu's
// mm_dtype=bf16) both legs are rounded to bf16 as they are staged, after
// the mix, as dy4tpu's _kernel / _audio_kernel cast them before the dot;
// the tails stay float32.

#include "rational.cuh"

namespace {

using rational::Item;
using rational::Plan;

struct AudioIo {
  const float *h, *h2;                     // h_audio [k]; no second filter
  const float *fmd, *sb, *nco;             // [c, n_in]
  const float *mono_tail, *stereo_tail;    // [c, s]
  float *mono, *left, *right;              // [c, m_out]
  float *mono_tail_out, *stereo_tail_out;  // [c, s]
  bool bf16;                               // stage both legs at bf16

  __device__ __forceinline__ float2 tail(long long row, int w, int s) const {
    return rational::bf16(
        make_float2(mono_tail[row * s + w], stereo_tail[row * s + w]), bf16);
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
  __device__ __forceinline__ float2 mix_raw(float a, float b,
                                            float c) const {
    return make_float2(a, __fmul_rn(__fmul_rn(b, c), 2.0f));
  }
  __device__ __forceinline__ float2 mix(float a, float b, float c) const {
    return rational::bf16(mix_raw(a, b, c), bf16);
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
    rational::store_input_tails(*this, p, it, xw, mono_tail_out,
                                stereo_tail_out, ctid);
  }
};

// The kernel: a persistent block of the tile resampler (rational.cuh).
template <int P, int QT>
__global__ void __launch_bounds__(rational::kMaxThreads, 1)
    audio_rational_kernel(AudioIo io, Plan p) {
  rational::run<AudioIo, P, QT>(io, p);
}

struct Kernel {
  template <int P, int QT>
  static auto fn() {
    return audio_rational_kernel<P, QT>;
  }
};

}  // namespace

// fmd, sb, nco: [c, n_in]; h: [k]; tails [c, (k-1)/up]; outputs
// [c, n_in*up/down] and the new tails; bf16 != 0 stages both legs at bf16
// (the note; h comes rounded); then resample_cuda._tile_plan's plan.
// Returns cudaGetLastError() after the launch (0 = launched;
// cudaErrorInvalidValue, launching nothing, for a plan the kernel cannot
// run).
extern "C" int dy4_audio_rational(
    const float* fmd, const float* sb, const float* nco, const float* h,
    const float* mono_tail, const float* stereo_tail, float* mono,
    float* left, float* right, float* mono_tail_out, float* stereo_tail_out,
    long long c, int n_in, int up, int down, int k, int bf16, int span,
    int dinv, int phases, int tmul, int tinv, int lead_group, int lead_mod,
    int lx, int guard, int rows, int cycles, int n_tiles, int halo_cycles,
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
                   stereo_tail_out, bf16 != 0};
  return rational::launch<Kernel>(io, p, stream);
}
