// B10: the batched FFT over the last axis.  Replaces dy4tpu/ops/fft_pallas.py
// :: fft_pallas (the four-step Pallas kernel, _kernel), which serves
// dy4tpu/ops/fft.py :: estimate_psd on the TPU.
//
// What it computes: X[b, k] = sum_n x[b, n] exp(-2 pi i n k / N) for every
// row b of a [B, N] block, N a power of two in 4..2048 (the N that
// fft_pallas takes), x real float32 (no imaginary plane is read or made) or
// interleaved complex64, X interleaved complex64 in natural order, the
// order of torch.fft.fft.
//
// What bounds it on the card: device memory.  At the PSD path's geometry
// (512 channels x 150 segments of N = 512, real in) a call reads 157 MB and
// writes 315 MB, 0.141 ms at 3.35 TB/s, against 5 N log2 N = 23 kFLOP a row
// (1.77 GFLOP, 0.026 ms at 67 TFLOP/s).  So the work between the load and
// the store has to stay off the critical path: few shared-memory passes,
// few barriers, no bank conflicts.
//
// The design: a Stockham auto-sort FFT with a register radix plan.  The
// radix sequence comes from the caller (ops/fft_cuda.py :: _plan: radix 8
// passes, then one of 4 or 2; 512 = 8.8.8, 2048 = 8.8.8.4; 4 = 4), with
// Ns the product of the radices before a pass.  Each thread owns E = 8
// elements of one row (E = 4 at N = 4) in registers; a pass of radix R
// runs E / R butterflies per thread, butterfly b reading elements
// b + r N/R, scaling element r by W_{Ns R}^{(b mod Ns) r} and writing its
// R-point DFT to (b / Ns) Ns R + (b mod Ns) + r Ns, so the row ends in
// natural order with no reordering pass.  The first pass reads device
// memory straight into registers (lane t takes elements t + r N/8, so
// neighbouring lanes read neighbouring words); the last pass writes
// element b + r N/R of the row, neighbouring lanes on neighbouring 8-byte
// words; the passes between exchange through two shared buffers in turn,
// one __syncthreads() per exchange (N = 512: three passes, two
// exchanges).
// The buffers are XOR-swizzled in 16-element groups (swizzle below) so
// that every exchange of the radix-8 passes takes a warp the minimum two
// wavefronts.  The block (256 threads, 2048 / N rows at a time) walks the
// rows in rounds, loading the next round's elements into registers
// before it transforms the current one, so the device-memory load is in
// flight during the passes.  The twiddles W_{Ns R}^{k r} of each pass come
// from one complex64 table the wrapper builds on the host in float64
// ([pass][r - 1][k], so neighbouring lanes read neighbouring entries), and
// are staged in shared memory once per block.
//
// The TPU kernel's shape is not carried over: its dense 128-point DFT as an
// MXU matmul costs 8 N N2 operations a row (0.54 MFLOP at N = 512, 20x the
// FFT's) and would hold this card, without float32 tensor cores, far above
// its bound.  Float32 FMA only: TF32 mma would miss the 1e-5 tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinLog2 = 2;       // N >= 4
constexpr int kMaxLog2 = 11;      // N <= 2048
constexpr int kMaxPasses = 4;     // 2048 = 8.8.8.4

struct Plan {
  int passes;
  int log2r[kMaxPasses];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // -i a
  return make_float2(a.y, -a.x);
}

// In-place R-point DFTs, natural order out: X[k] = sum_r v[r] W_R^{rk}.
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 s0 = cadd(a, c), d0 = csub(a, c);
  const float2 s1 = cadd(b, d), d1 = mul_neg_i(csub(b, d));
  a = cadd(s0, s1);
  c = csub(s0, s1);
  b = cadd(d0, d1);
  d = csub(d0, d1);
}

template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  dft2(v[0], v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  dft4(v[0], v[1], v[2], v[3]);
}

// radix 8 as two radix-4 DFTs of the even and odd elements and a radix-2
// stage with W_8^k, k < 4
template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float c = 0.70710678118654752f;
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = cmul(o1, make_float2(c, -c));
  o2 = mul_neg_i(o2);
  o3 = cmul(o3, make_float2(-c, -c));
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// The exchange buffers' swizzle: the low 4 bits of an element index are
// XORed with bits 4..6 of it (and bit 6 again into bit 3), a permutation
// inside each aligned group of 16 elements (128 bytes, the 32 banks).  A
// radix-8 pass at Ns = 1 writes elements 8b + r and at Ns = 8 elements
// 64 (b / 8) + b % 8 + 8r: unswizzled, 8 and 2 of a half-warp's 16 lanes
// would share a bank; swizzled, the 16 lanes land on 16 different
// 8-byte slots.  The reads (b + r N/R, neighbouring b) stay a
// permutation of one group.
__device__ __forceinline__ int swz(int i) {
  const int s = i >> 4;
  return i ^ ((s & 7) | ((s & 4) << 1));
}

// One pass of radix R (R <= E) on the thread's E elements: E / R
// butterflies b = j + q tr.  The first pass finds its elements already in
// registers and has no twiddles (Ns = 1); the others read theirs from
// src.  Every pass but the last writes to dst; the last writes the row's
// natural-order elements b + r Ns (Ns R = N) to out_row.
template <int R, int E>
__device__ __forceinline__ void run_pass(
    float2 (&v)[E], bool first, bool last, int ns, int log2ns, int n,
    const float2* __restrict__ src, float2* __restrict__ dst,
    float2* __restrict__ out_row, const float2* __restrict__ tw, int j,
    int tr, int row_base, bool live) {
  constexpr int kPer = E / R;
  constexpr int kLog2R = R == 8 ? 3 : (R == 4 ? 2 : 1);
  const int stride_in = n >> kLog2R;
  if (!first) {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[q * R + r] = src[swz(row_base + j + q * tr + r * stride_in)];
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int b = j + q * tr;
    if (!first) {
      const int k = b & (ns - 1);
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[q * R + r] = cmul(v[q * R + r], tw[(r - 1) * ns + k]);
    }
    dft<R>(v + q * R);
  }
  if (!last) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = j + q * tr;
      const int o = ((b >> log2ns) << (log2ns + kLog2R)) | (b & (ns - 1));
#pragma unroll
      for (int r = 0; r < R; ++r)
        dst[swz(row_base + o + r * ns)] = v[q * R + r];
    }
  } else if (live) {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r)
        out_row[j + q * tr + r * ns] = v[q * R + r];
  }
}

// Elements t + r N/E of one row into registers (zeros for a row past the
// end).
template <int E, bool kComplex>
__device__ __forceinline__ void load_row(float2 (&v)[E],
                                         const float* __restrict__ x,
                                         long long row, bool live, int n,
                                         int j) {
  const int stride = n / E;
  if (kComplex) {
    const float2* xr = reinterpret_cast<const float2*>(x) + row * n + j;
#pragma unroll
    for (int r = 0; r < E; ++r)
      v[r] = live ? __ldg(xr + r * stride) : make_float2(0.0f, 0.0f);
  } else {
    const float* xr = x + row * n + j;
#pragma unroll
    for (int r = 0; r < E; ++r)
      v[r] = make_float2(live ? __ldg(xr + r * stride) : 0.0f, 0.0f);
  }
}

template <int E, bool kComplex>
__global__ void __launch_bounds__(kThreads) fft_stockham_kernel(
    const float* __restrict__ x, const float2* __restrict__ tw_g,
    int tw_len, float2* __restrict__ out, long long rows, int n,
    Plan plan) {
  extern __shared__ float2 smem[];
  float2* tw = smem;                         // [tw_len] every pass's twiddles
  float2* buf0 = smem + tw_len;              // the two exchange buffers,
  float2* buf1 = buf0 + kThreads * E;        // [rows_per_round, N] each
  const int tid = threadIdx.x;
  for (int i = tid; i < tw_len; i += kThreads) tw[i] = tw_g[i];
  __syncthreads();

  const int tr = n / E;                      // threads per row
  const int rows_per_round = kThreads / tr;
  const int j = tid % tr;
  const int row_in = tid / tr;
  const int row_base = row_in * n;           // the row in a buffer
  const long long rounds = (rows + rows_per_round - 1) / rows_per_round;

  long long round = blockIdx.x;
  float2 nxt[E];
  {
    const long long row = round * rows_per_round + row_in;
    load_row<E, kComplex>(nxt, x, row, round < rounds && row < rows, n, j);
  }
  // Pass p writes buffer (p + c) & 1 and pass p + 1 reads it.  The last
  // pass has no barrier after it, so the next round's first pass must
  // write the other buffer than the one the last pass reads: with an
  // even number of passes c flips every round.
  int c = 0;
  for (; round < rounds; round += gridDim.x) {
    const long long row = round * rows_per_round + row_in;
    const bool live = row < rows;
    float2 v[E];
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = nxt[r];
    {
      const long long nround = round + gridDim.x;
      const long long nrow = nround * rows_per_round + row_in;
      load_row<E, kComplex>(nxt, x, nrow, nround < rounds && nrow < rows,
                            n, j);
    }
    float2* out_row = out + row * n;
    int log2ns = 0;
    int tw_off = 0;
#pragma unroll 1
    for (int p = 0; p < plan.passes; ++p) {
      const int lr = plan.log2r[p];
      const int ns = 1 << log2ns;
      const bool first = p == 0, last = p == plan.passes - 1;
      const float2* src = ((p + c + 1) & 1) ? buf1 : buf0;  // pass p - 1's
      float2* dst = ((p + c) & 1) ? buf1 : buf0;
      if (lr == 3) {
        if constexpr (E >= 8)
          run_pass<8, E>(v, first, last, ns, log2ns, n, src, dst, out_row,
                         tw + tw_off, j, tr, row_base, live);
      } else if (lr == 2) {
        run_pass<4, E>(v, first, last, ns, log2ns, n, src, dst, out_row,
                       tw + tw_off, j, tr, row_base, live);
      } else {
        run_pass<2, E>(v, first, last, ns, log2ns, n, src, dst, out_row,
                       tw + tw_off, j, tr, row_base, live);
      }
      if (!first) tw_off += ((1 << lr) - 1) * ns;
      log2ns += lr;
      if (!last) __syncthreads();
    }
    c ^= (plan.passes & 1) ^ 1;
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

// Bytes of dynamic shared memory one block takes: the twiddle table and,
// with more than one pass, the two exchange buffers.
size_t smem_bytes(int tw_len, int passes, int e) {
  return (static_cast<size_t>(tw_len) +
          (passes > 1 ? 2 * static_cast<size_t>(kThreads) * e : 0)) *
         sizeof(float2);
}

template <int E, bool kComplex>
int launch(const float* x, const float2* tw, int tw_len, float2* out,
           long long rows, int n, const Plan& plan, cudaStream_t stream) {
  auto kernel = fft_stockham_kernel<E, kComplex>;
  const size_t smem = smem_bytes(tw_len, plan.passes, E);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int rows_per_round = kThreads / (n / E);
  const long long rounds = (rows + rows_per_round - 1) / rows_per_round;
  // one wave of resident blocks, each walking its share of the rounds
  const long long cap =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(rounds < cap ? rounds : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(x, tw, tw_len, out, rows, n,
                                             plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B10.  x [rows, n] float32 (is_complex = 0) or interleaved complex64
// (is_complex = 1); out [rows, n] complex64, all row-major; n a power of
// two in 4..2048.  plan: the log2 radices of the passes, 4 bits each from
// the lowest (ops/fft_cuda.py :: _plan), each 1..3 and at most 3 above the
// first, summing to log2 n, the first 3 (2 at n = 4); tw [tw_len]
// complex64: for each pass p >= 1 of radix R after radices of product Ns,
// W_{Ns R}^{k r} at [(r - 1) Ns + k], r = 1..R-1, k < Ns, passes in
// order.  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an n, plan or table length outside that.
extern "C" int dy4_fft(const float* x, int is_complex, const void* tw,
                       int tw_len, void* out, long long rows, int n,
                       int plan_code, void* stream) {
  const int log2n = log2_of(n);
  if (log2n < kMinLog2 || log2n > kMaxLog2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = n >= 8 ? 8 : 4;
  Plan plan{};
  int sum = 0, ns = 1, want_tw = 0;
  for (int code = plan_code; code != 0; code >>= 4) {
    const int lr = code & 15;
    if (plan.passes == kMaxPasses || lr < 1 || (1 << lr) > e ||
        (plan.passes == 0 && (1 << lr) != e))
      return static_cast<int>(cudaErrorInvalidValue);
    if (plan.passes > 0) want_tw += ((1 << lr) - 1) * ns;
    plan.log2r[plan.passes++] = lr;
    sum += lr;
    ns <<= lr;
  }
  if (sum != log2n || tw_len != want_tw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const auto* xf = x;
  const auto* twc = static_cast<const float2*>(tw);
  auto* o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (e == 8)
    return is_complex ? launch<8, true>(xf, twc, tw_len, o, rows, n, plan, s)
                      : launch<8, false>(xf, twc, tw_len, o, rows, n, plan, s);
  return is_complex ? launch<4, true>(xf, twc, tw_len, o, rows, n, plan, s)
                    : launch<4, false>(xf, twc, tw_len, o, rows, n, plan, s);
}
