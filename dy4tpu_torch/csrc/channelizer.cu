// B7: the polyphase branch FIRs of the wideband channelizer, straight from
// the raw interleaved u8 capture.  Replaces dy4tpu/ops/channelizer.py ::
// channelize_block_u8 (_kernel_chan, with the plan of _hchan_plan and
// _build_hchan); the length-C DFT across the branches stays a matmul in the
// wrapper's caller, as dy4tpu leaves it to an XLA einsum.
//
// Per band row b (the math of channelize_block_interleaved):
//   ext = [tail interleaved (2(K-1)) || (x_u8 - 128) / 128 (2 n_w)],  K = C*T
//   w[b, m, j] = sum_{q<T} pcol[j, q] * ext[(m + T-1-q) * 2C + j],
//   pcol[j, q] = p[C-1 - j/2, q]       (branch order flipped, each tap
//                                       repeated for the I and Q columns)
// for m < M = n_w / C and j < 2C, and the new planar tails are the last K-1
// complex samples of ext.  Row r of ext is x[(r - T) * 2C + 2 ...]: because
// 2(K-1) = 2CT - 2, it starts one complex sample before a 2C boundary of
// x, and rows r < T hold (some of) the carried tail.
//
// What bounds it on the card: device memory.  At the wideband bench point
// (C=16, T=12, 32 bands, n_w = 122,880) a step reads 7.9 MB of u8 and
// writes 31 MB of float32 w (0.0118 ms at 3.35 TB/s), against 94 M
// multiply-adds.  The first design (a block per 8192 outputs, one output a
// thread) read its T taps and T window samples from shared memory for
// each output (2T loads for T FMAs, about twice the bytes bound in
// shared-memory wavefronts), staged the window byte by byte as float32,
// and ran 15 blocks on 132 SMs at the tool's one band.
//
// The design (channelizer_cuda._tile_plan sizes it; Plan below):
//   * blocks walk items it, it + gridDim.x, ...: an item is a tile of
//     `tile` rows m of one band (a band's last tile may be shorter);
//   * the raw u8 window of an item, the x bytes its outputs read from the
//     16-byte boundary at or below the first, is copied into shared
//     memory with 16-byte cp.async (byte copies only where a 16-byte chunk
//     leaves the tensor), one item ahead, into the other of two stage
//     buffers; a tile after a band's first reads its T-1 rows of halo from
//     x again; a tile whose window reaches below x (m0 < T) also copies
//     the carried tail into its stage's head (4-byte cp.async), where two
//     heads take at most a quarter of the block's shared memory (else its
//     units read the tail from device memory, as at C*T above ~3600); the
//     band's first tile writes the new tail;
//   * a thread takes units (chunk of R consecutive rows, column j of w),
//     lanes over j first, so 2C need not divide the block: it holds
//     pcol[j, :] in registers (loaded again only where its column
//     changes) and slides over the R + T-1 window
//     rows of the chunk from the top, one shared-memory byte read
//     (normalised in registers: 2^23 + b as float bits, one FMA) feeding
//     up to R FMAs, so (R + T-1) / R reads an output where the first
//     design took 2T.  At 2C >= 32 a warp's stores are 128 consecutive
//     bytes of w, below it whole 32-byte sectors;
//   * T is a runtime value: a kernel is instantiated for a tap group G
//     (T rounded up to 4, or 16 above 16 taps) and R in {4, 8, 12, 16}, and
//     runs TM = T rounded up to G taps, the first TM - T of them zero,
//     in groups of G with the sums carried from group to group: the zero
//     taps read rows above the window (inside the stage), and a sum from
//     +0 plus 0 * x stays +0, so the loops carry no predicate.
// The plan: blocks of 256 threads, as many an SM as fit, one round of
// them at once (walking the items, the prefetch overlapping, where the
// stages' shared memory makes tiles short: C >= 32 at T = 12); R = 16
// where the units fill half a round of threads; tiles of whole passes of
// the block.  On an H100 the kernel's time alone moved little across
// plans of R >= 12 with tiles of 128 rows or more (chip_smoke.py's plan
// sweep prints the pick beside the fastest of twelve).
//
// Numerics: the normalize is exact in float32, so the new tails equal the
// plain version's bit for bit; each output is one chain of fmaf over
// q = 0..T-1 in the plain version's order from +0, whatever the plan, so
// every plan gives the same bits and w matches the plain version (mul,
// then add) to float32 tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxThreads = 512;  // channelizer_cuda.MAX_THREADS
constexpr int kSmemMax = 232448;  // kernels.SMEM_MAX: 227 KB a block

// The geometry and channelizer_cuda.TilePlan, as the entry point takes
// them.
struct Plan {
  long long bands, n2;   // band rows; u8 bytes a row (2C * m)
  int c, c2, t;          // C, 2C, T
  int tm, g;             // taps run (T rounded up to G), taps a group
  int k1;                // K-1: complex samples of a tail
  int m;                 // rows of w a band
  int rows;              // R: rows of a unit
  int tile, n_tiles, items;
  int threads, ctas;
  int head;              // bytes of a stage's head (the tail), or 0
  int stage, smem;       // bytes of a stage (head, u8 window) and of both
};

__host__ __device__ inline long long r16(long long n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline int tap_group(int t) {
  return t <= 16 ? (t + 3) / 4 * 4 : 16;
}

__host__ __device__ inline int tap_bound(int t) {
  const int g = tap_group(t);
  return (t + g - 1) / g * g;
}

// A stage's head, the carried tail interleaved as float32 (2(K-1)
// floats), staged for a tile whose window reaches below x where the two
// heads take at most a quarter of a block's shared memory; else 0, and a
// unit reads the tail from device memory.
__host__ __device__ inline long long head_bytes(int c2, int t) {
  const long long h = r16(4 * (static_cast<long long>(c2) * t - 2));
  return 2 * h <= kSmemMax / 4 ? h : 0;
}

// The u8 window of a tile: (tile + T-1) rows of 2C bytes from up to 15
// bytes below its first, and the R-1 + TM-T rows a partial last unit and
// the zero taps read past the tile (their values unused).
__host__ __device__ inline long long stage_bytes(int c2, int t, int rows,
                                                 int tile) {
  return r16(15 + static_cast<long long>(tile + rows + tap_bound(t) - 2) *
                      c2);
}

inline bool plan_ok(const Plan& p) {
  return p.c >= 1 && p.t >= 1 && p.m >= 1 &&
         p.n2 == static_cast<long long>(p.c2) * p.m &&
         (p.rows == 4 || p.rows == 8 || p.rows == 12 || p.rows == 16) &&
         p.tile >= 1 && p.tile <= p.m &&
         p.n_tiles == (p.m + p.tile - 1) / p.tile &&
         static_cast<long long>(p.items) == p.bands * p.n_tiles &&
         p.threads >= 32 && p.threads <= kMaxThreads &&
         p.threads % 32 == 0 && p.ctas >= 1 && p.ctas <= p.items &&
         p.stage == p.head + stage_bytes(p.c2, p.t, p.rows, p.tile) &&
         p.smem == 2LL * p.stage;
}

// ---- the copies (cp.async: the copy runs while the block computes) ----

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy group but the newest has landed
__device__ __forceinline__ void copy_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Item `it`: band `band`, rows [m0, m1) of w; its window is x bytes
// [lo, hi) of the band row (rows below T come from the tail: lo >= 0).
struct Item {
  long long band, lo, hi;
  int m0, m1;
};

__device__ __forceinline__ Item item_of(const Plan& p, int it) {
  Item i;
  i.band = it / p.n_tiles;
  i.m0 = (it - static_cast<int>(i.band) * p.n_tiles) * p.tile;
  i.m1 = i.m0 + p.tile < p.m ? i.m0 + p.tile : p.m;
  const long long lo = static_cast<long long>(i.m0 - p.t) * p.c2 + 2;
  i.lo = lo > 0 ? lo : 0;
  i.hi = static_cast<long long>(i.m1 - 1) * p.c2 + 2;
  return i;
}

// The window's offset from a 16-byte boundary: x byte e of the item's band
// row sits at stage index e - lo + shift.
__device__ __forceinline__ int stage_shift(const uint8_t* x, const Item& i,
                                           long long n2) {
  return static_cast<int>(
      reinterpret_cast<uintptr_t>(x + i.band * n2 + i.lo) & 15);
}

// Thread `tid` of the block: its share of item `i`'s copies into a
// stage (head, window).
__device__ __forceinline__ void fetch(const Plan& p, const Item& i,
                                      const uint8_t* __restrict__ x,
                                      const float* __restrict__ tail_i,
                                      const float* __restrict__ tail_q,
                                      unsigned char* buf, int tid) {
  if (p.head && i.m0 < p.t) {          // the window reaches the tail
    const float* ti = tail_i + i.band * p.k1;
    const float* tq = tail_q + i.band * p.k1;
    float* head = reinterpret_cast<float*>(buf);
    for (int e = tid; e < 2 * p.k1; e += p.threads)
      copy4(head + e, (e & 1 ? tq : ti) + (e >> 1));
  }
  uint8_t* stage = buf + p.head;
  const uintptr_t x0 = reinterpret_cast<uintptr_t>(x);
  const uintptr_t x1 = x0 + static_cast<uintptr_t>(p.bands * p.n2);
  const uintptr_t row = x0 + static_cast<uintptr_t>(i.band * p.n2);
  const uintptr_t a0 = (row + i.lo) & ~static_cast<uintptr_t>(15);
  const int chunks = static_cast<int>((row + i.hi + 15 - a0) / 16);
  for (int k = tid; k < chunks; k += p.threads) {
    const uintptr_t src = a0 + 16 * static_cast<uintptr_t>(k);
    uint8_t* dst = stage + 16 * k;
    if (src >= x0 && src + 16 <= x1) {
      copy16(dst, reinterpret_cast<const void*>(src));
    } else {
      for (int b = 0; b < 16; ++b)
        if (src + b >= x0 && src + b < x1)
          dst[b] = *reinterpret_cast<const uint8_t*>(src + b);
    }
  }
}

// (b - 128) / 128, exactly: the float 2^23 + b from its bits, then one
// FMA whose exact result is representable.
__device__ __forceinline__ float norm_u8(uint8_t b) {
  return __fmaf_rn(__int_as_float(0x4B000000 | b), 0.0078125f, -65537.0f);
}

// One group of G taps of a unit: outputs r_a .. r_a + R-1 of column j
// into acc.  Window step kk (kk = 0 first) is stage index s_top - kk * 2C
// and feeds output i with the group's tap q = kk - (R-1 - i), so each
// output runs its taps in order.  kHead: the window may reach below x
// (rows under T), where ext is the carried tail: stage index s < lim is
// x byte s - lim < 0, ext element e = s - lim + 2(K-1): head[e] where
// the stage has a head, else element e >> 1 of the tail ti (e even) or tq.
template <int G, int R, bool kHead>
__device__ __forceinline__ void group_sums(
    const uint8_t* stage, int s_top, int c2, int lim, const float* head,
    const float* __restrict__ ti, const float* __restrict__ tq, int s2,
    const float (&tap)[G], float (&acc)[R]) {
#pragma unroll
  for (int kk = 0; kk < R + G - 1; ++kk) {
    const int s = s_top - kk * c2;
    float v;
    if (kHead && s < lim) {
      const int e = s - lim + s2;
      v = head ? head[e] : (e & 1 ? tq : ti)[e >> 1];
    } else {
      v = norm_u8(stage[s]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = kk - (R - 1 - i);
      if (q >= 0 && q < G) acc[i] = __fmaf_rn(tap[q], v, acc[i]);
    }
  }
}

template <int G, int R>
__global__ void __launch_bounds__(kMaxThreads, 2) channelizer_kernel(
    const uint8_t* __restrict__ x, const float* __restrict__ pt,
    const float* __restrict__ tail_i, const float* __restrict__ tail_q,
    float* __restrict__ w, float* __restrict__ tail_i_out,
    float* __restrict__ tail_q_out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int zeros = p.tm - p.t;       // leading zero taps
  const int groups = p.tm / G;
  const int s2 = 2 * p.k1;
  // a thread's first unit of an item (chunk, column) and its step to the
  // next, `threads` units on
  const int ch0 = tid / p.c2, j0 = tid - ch0 * p.c2;
  const int step_ch = p.threads / p.c2;
  const int step_j = p.threads - step_ch * p.c2;
  float tap[G];                       // taps q0 .. q0 + G-1 of column tap_j
  int tap_j = -1;

  int it = blockIdx.x;
  if (it < p.items) fetch(p, item_of(p, it), x, tail_i, tail_q, smem, tid);
  copy_commit();
  for (int k = 0; it < p.items; it += gridDim.x, ++k) {
    const int next = it + static_cast<int>(gridDim.x);
    if (next < p.items)
      fetch(p, item_of(p, next), x, tail_i, tail_q,
            smem + ((k + 1) & 1) * p.stage, tid);
    copy_commit();
    copy_wait_prior();
    __syncthreads();

    const Item i = item_of(p, it);
    const unsigned char* buf = smem + (k & 1) * p.stage;
    const float* head =
        p.head ? reinterpret_cast<const float*>(buf) : nullptr;
    const uint8_t* stage = buf + p.head;
    const int shift = stage_shift(x, i, p.n2);
    // stage index of x byte 2 + m0 * 2C (window row m0 + T: output m0's
    // tap 0, column 0)
    const int base =
        2 + static_cast<int>(static_cast<long long>(i.m0) * p.c2 - i.lo) +
        shift;
    const float* ti = tail_i + i.band * p.k1;
    const float* tq = tail_q + i.band * p.k1;
    const int n_chunks = (i.m1 - i.m0 + R - 1) / R;
    // unit (chunk ch, column j) of the item: its R outputs into w
    auto unit = [&](int ch, int j) {
      const int r_a = i.m0 + ch * R;
      const float* prow = pt + (p.c - 1 - j / 2) * p.t - zeros;
      // window step 0 of the unit's first group: its top row
      const int s_top = (r_a - i.m0 + R - 2 + zeros) * p.c2 + j + base;
      const bool below = r_a < p.t;   // the window reaches the tail
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      if (G < 16 || groups == 1) {
        // T <= 16: the taps stay while the column does
        if (j != tap_j) {
#pragma unroll
          for (int q = 0; q < G; ++q) tap[q] = q < zeros ? 0.0f : prow[q];
          tap_j = j;
        }
        if (below)
          group_sums<G, R, true>(stage, s_top, p.c2, shift, head, ti, tq,
                                 s2, tap, acc);
        else
          group_sums<G, R, false>(stage, s_top, p.c2, shift, head, ti, tq,
                                  s2, tap, acc);
      } else {
        for (int q0 = 0; q0 < p.tm; q0 += G) {
#pragma unroll
          for (int q = 0; q < G; ++q)
            tap[q] = q0 + q < zeros ? 0.0f : prow[q0 + q];
          if (below)
            group_sums<G, R, true>(stage, s_top - q0 * p.c2, p.c2, shift,
                                   head, ti, tq, s2, tap, acc);
          else
            group_sums<G, R, false>(stage, s_top - q0 * p.c2, p.c2, shift,
                                    head, ti, tq, s2, tap, acc);
        }
      }
      float* out = w + (i.band * p.m + r_a) * p.c2 + j;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r_a + r < i.m1) out[r * p.c2] = acc[r];
    };
    if (step_j == 0) {
      // 2C divides the block: the thread's column is fixed
      for (int ch = ch0; ch < n_chunks; ch += step_ch) unit(ch, j0);
    } else {
      for (int ch = ch0, j = j0; ch < n_chunks;) {
        unit(ch, j);
        ch += step_ch;
        j += step_j;
        if (j >= p.c2) {
          j -= p.c2;
          ++ch;
        }
      }
    }

    if (i.m0 == 0) {
      // new tails: ext[n2 + e] for e < 2(K-1), the last K-1 complex
      // samples (the old tail where the row is shorter than it)
      const uint8_t* xb = x + i.band * p.n2;
      const long long t0 = i.band * p.k1;
      for (int e = tid; e < s2; e += p.threads) {
        const long long s = p.n2 + e;
        const float v = s < s2 ? (s & 1 ? tq : ti)[s >> 1]
                               : norm_u8(xb[s - s2]);
        (e & 1 ? tail_q_out : tail_i_out)[t0 + (e >> 1)] = v;
      }
    }
    __syncthreads();   // the stage is free for the item after next
  }
}

constexpr int kMaxDevices = 64;

// The shared memory a kernel may take is set once a device, and again
// only to raise it: the call costs host time a small launch would notice.
template <int G, int R>
int launch_with(const uint8_t* x, const float* pt, const float* ti,
                const float* tq, float* w, float* ti_out, float* tq_out,
                const Plan& p, void* stream) {
  static std::mutex lock;
  static int smem_set[kMaxDevices];   // bytes set on each device
  auto kernel = channelizer_kernel<G, R>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> guard(lock);
    if (dev >= kMaxDevices || smem_set[dev] < p.smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) smem_set[dev] = p.smem;
    }
  }
  kernel<<<p.ctas, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      x, pt, ti, tq, w, ti_out, tq_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one block takes (channelizer_cuda's
// plan computes the same); the wrapper checks it against the card's
// 227 KB before a launch.
extern "C" long long dy4_channelizer_smem(int c, int t, int rows, int tile) {
  return 2 * (head_bytes(2 * c, t) + stage_bytes(2 * c, t, rows, tile));
}

// B7.  x_u8 [bands, n2] u8 (I even, Q odd; n2 a positive multiple of 2C),
// p [C, T] (p[r, q] = h[qC + r]), tail_i/tail_q [bands, C*T-1] float32;
// w [bands, n2/(2C), 2C] and the new tails [bands, C*T-1] float32, all
// row-major; `launch` the geometry and the plan, eleven numbers
// (channelizer_cuda._launch_array: bands, n2, C, T, then rows, tile,
// n_tiles, items, threads, ctas, smem), so that a call from Python
// converts few arguments.  Returns cudaGetLastError() after the launch (0
// = launched; a plan the kernel cannot run is refused with
// cudaErrorInvalidValue and no launch).
extern "C" int dy4_channelizer(const uint8_t* x_u8, const float* p,
                               const float* tail_i, const float* tail_q,
                               float* w, float* tail_i_out, float* tail_q_out,
                               const long long* launch, void* stream) {
  const long long bands = launch[0], n2 = launch[1];
  if (bands <= 0) return 0;
  for (int i = 2; i < 11; ++i)
    if (launch[i] < 1 || launch[i] > (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(launch[2]), t = static_cast<int>(launch[3]);
  if (n2 < 2LL * c || n2 / (2LL * c) > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  pl.bands = bands;
  pl.n2 = n2;
  pl.c = c;
  pl.c2 = 2 * c;
  pl.t = t;
  pl.tm = tap_bound(t);
  pl.g = tap_group(t);
  pl.k1 = c * t - 1;
  pl.m = static_cast<int>(n2 / (2LL * c));
  pl.rows = static_cast<int>(launch[4]);
  pl.tile = static_cast<int>(launch[5]);
  pl.n_tiles = static_cast<int>(launch[6]);
  pl.items = static_cast<int>(launch[7]);
  pl.threads = static_cast<int>(launch[8]);
  pl.ctas = static_cast<int>(launch[9]);
  pl.smem = static_cast<int>(launch[10]);
  pl.head = static_cast<int>(head_bytes(pl.c2, t));
  pl.stage = pl.smem / 2;
  if (!plan_ok(pl)) return static_cast<int>(cudaErrorInvalidValue);
  switch (pl.g * 100 + pl.rows) {
#define DY4_CASE(G, R)                                                     \
  case G * 100 + R:                                                        \
    return launch_with<G, R>(x_u8, p, tail_i, tail_q, w, tail_i_out,       \
                             tail_q_out, pl, stream);
    DY4_CASE(4, 4) DY4_CASE(4, 8) DY4_CASE(4, 12) DY4_CASE(4, 16)
    DY4_CASE(8, 4) DY4_CASE(8, 8) DY4_CASE(8, 12) DY4_CASE(8, 16)
    DY4_CASE(12, 4) DY4_CASE(12, 8) DY4_CASE(12, 12) DY4_CASE(12, 16)
    DY4_CASE(16, 4) DY4_CASE(16, 8) DY4_CASE(16, 12) DY4_CASE(16, 16)
#undef DY4_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
