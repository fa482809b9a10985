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
// (1.77 GFLOP, 0.026 ms at 67 TFLOP/s).  The design touches device memory
// once per element each way: a thread block loads kTileElems / N whole rows
// (at least one) into shared memory, in bit-reversed order, runs the log2 N
// radix-2 decimation-in-time stages there with a __syncthreads() between
// them, and stores the rows in natural order; neighbouring threads read and
// write neighbouring elements.  The twiddles W_N^k, k < N/2, come from a
// complex64 table the wrapper builds on the host in float64 (as dy4tpu's
// _consts builds its constants) and are staged in shared memory once per
// block.
//
// The TPU kernel's shape is not carried over: its dense 128-point DFT as an
// MXU matmul costs 8 N N2 operations a row (0.54 MFLOP at N = 512, 20x the
// FFT's) and would hold this card, without float32 tensor cores, far above
// its bound.  Float32 FMA only: TF32 mma would miss the 1e-5 tolerance.
// Speed work (radix 4, several rows per warp, fusing the Hann window or the
// |X|^2 epilogue) is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 2048;  // complex elements of the rows one block holds
constexpr int kMinLog2 = 2;       // N >= 4
constexpr int kMaxLog2 = 11;      // N <= 2048

__device__ inline float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads) fft_kernel(
    const float* __restrict__ x, int is_complex,
    const float2* __restrict__ tw, float2* __restrict__ out,
    long long rows, int log2n, int tile_rows) {
  extern __shared__ float2 smem[];
  const int n = 1 << log2n;
  const int half = n >> 1;
  float2* w = smem;         // [N/2] twiddles W_N^k
  float2* s = smem + half;  // [tile_rows, N] the rows being transformed
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const long long left = rows - row0;
  const int nr = left < tile_rows ? static_cast<int>(left) : tile_rows;
  const int elems = nr << log2n;
  const int rev_shift = 32 - log2n;

  for (int k = tid; k < half; k += kThreads) w[k] = tw[k];
  const long long base = row0 << log2n;
  if (is_complex) {
    const float2* xc = reinterpret_cast<const float2*>(x) + base;
    for (int e = tid; e < elems; e += kThreads) {
      const int r = e >> log2n;
      const unsigned k = static_cast<unsigned>(e & (n - 1));
      s[(r << log2n) + (__brev(k) >> rev_shift)] = xc[e];
    }
  } else {
    const float* xr = x + base;
    for (int e = tid; e < elems; e += kThreads) {
      const int r = e >> log2n;
      const unsigned k = static_cast<unsigned>(e & (n - 1));
      s[(r << log2n) + (__brev(k) >> rev_shift)] = make_float2(xr[e], 0.0f);
    }
  }
  __syncthreads();

  // stage ls: butterflies of span 2^ls inside groups of 2^(ls+1), twiddle
  // W_{2 span}^j = W_N^(j N / (2 span))
  const int butterflies = nr * half;
  for (int ls = 0; ls < log2n; ++ls) {
    const int span = 1 << ls;
    const int tw_shift = log2n - 1 - ls;
    for (int b = tid; b < butterflies; b += kThreads) {
      const int r = b >> (log2n - 1);
      const int k = b & (half - 1);
      const int j = k & (span - 1);
      const int i0 = (r << log2n) + ((k >> ls) << (ls + 1)) + j;
      const float2 a = s[i0];
      const float2 t = cmul(s[i0 + span], w[j << tw_shift]);
      s[i0] = make_float2(a.x + t.x, a.y + t.y);
      s[i0 + span] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }

  float2* o = out + base;
  for (int e = tid; e < elems; e += kThreads) o[e] = s[e];
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

}  // namespace

// B10.  x [rows, n] float32 (is_complex = 0) or interleaved complex64
// (is_complex = 1); tw [n/2] complex64, tw[k] = exp(-2 pi i k / n); out
// [rows, n] complex64, all row-major.  n a power of two in 4..2048.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an n outside that range.
extern "C" int dy4_fft(const float* x, int is_complex, const void* tw,
                       void* out, long long rows, int n, void* stream) {
  const int log2n = log2_of(n);
  if (log2n < kMinLog2 || log2n > kMaxLog2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const int tile_rows = n >= kTileElems ? 1 : kTileElems / n;
  const size_t smem =
      (static_cast<size_t>(n / 2) + static_cast<size_t>(tile_rows) * n) *
      sizeof(float2);
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  fft_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      x, is_complex, static_cast<const float2*>(tw),
      static_cast<float2*>(out), rows, log2n, tile_rows);
  return static_cast<int>(cudaGetLastError());
}
