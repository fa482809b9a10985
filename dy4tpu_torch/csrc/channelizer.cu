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
// complex samples of ext.  Because 2(K-1) = 2CT - 2 is not a multiple of
// 2C, row r of ext starts one complex sample before a 2C boundary of x:
// the kernel therefore indexes ext itself (tail below 2(K-1), x above) and
// never "row r = samples r*2C of x".
//
// What bounds it on the card: device memory.  At the wideband bench point
// (C=16, T=12, 32 bands, n_w = 122,880) a step reads 7.9 MB of u8 and
// writes 31 MB of float32 w, against 94 M multiply-adds, far below the
// SMs' float32 rate.  The design reads each input byte from device memory
// about once: a thread block takes `tm` consecutive rows m of one band
// (about kOut outputs) and stages the (tm + T-1) rows of ext they need,
// normalized, in shared memory, next to the taps transposed to
// pcolT[q, j] (so a warp reads consecutive words of both).  One thread
// computes one output (m, j) at a time with j fastest, so the stores of a
// warp are consecutive addresses of w.  The TPU kernel's banded [WIN, 128]
// MXU operator, its raw-scale tail, its offset row and its 2C | 128 gate
// are Mosaic layout choices and are not copied: any C and T are served
// while the shared memory fits (the wrapper checks it first).
//
// Numerics: the normalize is exact in float32, so the new tails equal the
// plain version's bit for bit; the T products are summed in the plain
// version's order of q but may contract into FMAs, so w matches it to
// float32 tolerance, not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 8192;  // outputs (m, j) per thread block, about

struct Geometry {
  long long n2;  // u8 bytes per band row = 2 n_w
  int c;         // channels C
  int c2;        // 2C: interleaved columns of w
  int t;         // taps per branch T
  int s2;        // 2(K-1): interleaved tail length
  long long m;   // rows of w per band, n_w / C
  int tm;        // rows of w per thread block
};

Geometry make_geometry(long long n2, int c, int t) {
  Geometry g;
  g.n2 = n2;
  g.c = c;
  g.c2 = 2 * c;
  g.t = t;
  g.s2 = 2 * (c * t - 1);
  g.m = n2 / g.c2;
  long long tm = kOut / g.c2;
  if (tm < 1) tm = 1;
  if (tm > g.m) tm = g.m > 0 ? g.m : 1;
  g.tm = static_cast<int>(tm);
  return g;
}

// pcolT [T, 2C] then the staged ext rows [tm + T-1, 2C], in floats
__host__ __device__ inline size_t smem_floats(const Geometry& g) {
  return static_cast<size_t>(g.t) * g.c2 +
         static_cast<size_t>(g.tm + g.t - 1) * g.c2;
}

// ext[e] of band row b: the carried tail below 2(K-1), the normalized
// block above
__device__ inline float ext_at(const uint8_t* x, const float* tail_i,
                               const float* tail_q, const Geometry& g,
                               long long e) {
  if (e < g.s2) {
    const long long k = e >> 1;
    return (e & 1) ? tail_q[k] : tail_i[k];
  }
  return (static_cast<float>(x[e - g.s2]) - 128.0f) * 0.0078125f;
}

__global__ void __launch_bounds__(kThreads) channelizer_kernel(
    const uint8_t* __restrict__ x_u8, const float* __restrict__ p,
    const float* __restrict__ tail_i, const float* __restrict__ tail_q,
    float* __restrict__ w, float* __restrict__ tail_i_out,
    float* __restrict__ tail_q_out, Geometry g) {
  extern __shared__ float smem[];
  float* pcol_t = smem;                  // [T, 2C]
  float* seg = smem + g.t * g.c2;        // [tm + T-1, 2C]
  const long long band = blockIdx.y;
  const int tid = threadIdx.x;
  const int k1 = g.s2 / 2;               // K-1
  const uint8_t* x = x_u8 + band * g.n2;
  const float* ti = tail_i + band * k1;
  const float* tq = tail_q + band * k1;

  const long long m0 = static_cast<long long>(blockIdx.x) * g.tm;
  long long rows = g.m - m0;
  if (rows > g.tm) rows = g.tm;
  if (rows < 0) rows = 0;

  for (int i = tid; i < g.t * g.c2; i += kThreads) {
    const int q = i / g.c2;
    const int j = i - q * g.c2;
    pcol_t[i] = p[(g.c - 1 - j / 2) * g.t + q];
  }
  // ext rows m0 .. m0 + rows + T-2, i.e. ext[m0*2C, (m0+rows+T-1)*2C)
  const long long base = m0 * g.c2;
  const int n_seg = static_cast<int>((rows + g.t - 1) * g.c2);
  if (rows > 0)
    for (int i = tid; i < n_seg; i += kThreads)
      seg[i] = ext_at(x, ti, tq, g, base + i);
  __syncthreads();

  float* wb = w + (band * g.m + m0) * g.c2;
  const int n_out = static_cast<int>(rows * g.c2);
  for (int o = tid; o < n_out; o += kThreads) {
    const int ml = o / g.c2;
    const int j = o - ml * g.c2;
    const float* s = seg + (ml + g.t - 1) * g.c2 + j;   // row ml + T-1
    float acc = 0.0f;
    for (int q = 0; q < g.t; ++q) acc += pcol_t[q * g.c2 + j] * s[-q * g.c2];
    wb[o] = acc;
  }

  if (blockIdx.x == 0) {
    // new tails: ext[n2 + i] for i < 2(K-1), the last K-1 complex samples
    for (int i = tid; i < g.s2; i += kThreads) {
      const float v = ext_at(x, ti, tq, g, g.n2 + i);
      (i & 1 ? tail_q_out : tail_i_out)[band * k1 + (i >> 1)] = v;
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes for a band row of
// m rows of w (n2 = 2Cm u8 bytes) through C branches of T taps.  The
// wrapper checks it against the card's 227 KB before a launch.
extern "C" long long dy4_channelizer_smem(int m, int c, int t) {
  const Geometry g = make_geometry(2LL * c * m, c, t);
  return static_cast<long long>(smem_floats(g) * sizeof(float));
}

// B7.  x_u8 [bands, n2] u8 (I even, Q odd; n2 a multiple of 2C, at least
// 2C), p [C, T] (p[r, q] = h[qC + r]), tail_i/tail_q [bands, C*T-1]
// float32; w [bands, n2/(2C), 2C] and the new tails [bands, C*T-1] float32,
// all row-major.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int dy4_channelizer(const uint8_t* x_u8, const float* p,
                               const float* tail_i, const float* tail_q,
                               float* w, float* tail_i_out, float* tail_q_out,
                               long long bands, long long n2, int c, int t,
                               void* stream) {
  if (bands <= 0) return 0;
  const Geometry g = make_geometry(n2, c, t);
  const size_t smem = smem_floats(g) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      channelizer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (g.m + g.tm - 1) / g.tm;
  const dim3 grid(static_cast<unsigned>(tiles > 0 ? tiles : 1),
                  static_cast<unsigned>(bands));
  channelizer_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x_u8, p, tail_i, tail_q, w, tail_i_out, tail_q_out, g);
  return static_cast<int>(cudaGetLastError());
}
