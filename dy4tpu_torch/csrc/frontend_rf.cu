// The RF stage of the receiver alone: u8 I/Q -> normalize -> the K-tap
// RF LPF decimating by `decim` on both legs -> the differentiator demod
// -> fm.  One kernel body, three ways for the u8 block to reach it:
//
// B11 (kBytes)  replaces dy4tpu/ops/frontend_pallas.py :: fused_frontend_raw
//               (_kernel_raw): the interleaved u8 row [c, bs], one byte
//               per thread, consecutive threads on consecutive bytes.
// B12 (kPlanes) replaces frontend_pallas.py :: fused_frontend (_kernel):
//               the u8 phase planes x20 [2D, c, M] the wrapper pre-splits
//               in torch (plane 2r + leg holds decimation phase r of leg
//               `leg`, M = bs/2/D); needs (K-1) % D == 0, so every phase of
//               the window starts on a whole plane sample.
// B13 (kWords)  replaces frontend_pallas.py :: fused_frontend_raw_pm
//               (_kernel_raw_pm): the row as 32-bit words [c, bs/4]; each
//               thread loads a word and takes its four bytes apart (little-
//               endian: bytes 0 and 2 are I, 1 and 3 are Q).
//
// Contract of all three: (iq_u8, h, iq_tail [c, 2, K-1], prev_i, prev_q
// [c]) -> fm [c, bs/2/D], the new iq_tail (the block's last K-1 complex
// samples, normalized: exact), and the new prev_i/prev_q (the last
// decimated I/Q).
//
// What bounds it on the card: the u8 read (bs bytes per row) is the only
// stream from device memory that scales with the input, fm is 1/(8D) of
// it in bytes; the 2K multiply-adds per fm sample are float32 work.  The
// TPU kernels' banded tap-parity matrices and window/dot interleave are
// MXU and VMEM devices and are not copied.  Here a thread block takes one
// row's tile of kThreads decimated outputs (the first one the sample
// before the tile, which the demod needs, so a tile emits kThreads - 1 fm
// samples) and loads the tile's window of the row into shared memory in
// polyphase order: ext sample e = e0 + v*D + r sits at [r][v].  Output t
// then reads [r][t + q] for tap a = q*D + r, so the 32 threads of a warp
// read 32 consecutive words for every tap, free of bank conflicts at any
// D.  Without the band stages a block needs only its window (about 24 KB
// at mode 0), so several blocks share an SM.
//
// Numerics: the normalize (x-128)/128 comes first and is exact in
// float32 (the TPU kernels' -128*sum(h) epilogue cancels in float32 and is
// not copied).  The taps are summed phase by phase with FMAs, so fm
// matches the plain torch version to float32 tolerance, amplified by the
// demod's 1/power where the I/Q pass near the origin; the new iq_tail
// comes straight from the block's bytes and is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // decimated outputs a block computes
constexpr int kFm = kThreads - 1;    // fm samples a block emits
constexpr float kScale = 0.0078125f; // 1/128

enum Source { kBytes = 0, kPlanes = 1, kWords = 2 };

struct Geom {
  long long c;     // rows
  long long bs;    // u8 bytes per row
  int n_in;        // complex samples per row = bs / 2
  int n_out;       // decimated samples = n_in / decim
  int decim;
  int s;           // RF taps - 1: the tail in complex samples
  int qmax;        // s / decim + 1: taps per phase, at most
  int lp;          // kThreads + s / decim: window samples per phase
};

Geom make_geom(long long c, long long bs, int decim, int k) {
  Geom g;
  g.c = c;
  g.bs = bs;
  g.n_in = static_cast<int>(bs / 2);
  g.n_out = g.n_in / decim;
  g.decim = decim;
  g.s = k - 1;
  g.qmax = g.s / decim + 1;
  g.lp = kThreads + g.s / decim;
  return g;
}

// Shared memory, in floats: taps [D, qmax], the I and Q windows [D, lp]
// each, the decimated I and Q of the tile [kThreads] each.
size_t smem_floats(const Geom& g) {
  return static_cast<size_t>(g.decim) * g.qmax +
         2 * static_cast<size_t>(g.decim) * g.lp + 2 * kThreads;
}

// Byte `b` of row `row` (0 <= b < bs; byte 2n + leg is leg `leg` of
// complex sample n), as the source holds it.
template <int kSrc>
__device__ inline unsigned raw_byte(const void* src, const Geom& g,
                                    long long row, long long b) {
  if (kSrc == kBytes) {
    return static_cast<const uint8_t*>(src)[row * g.bs + b];
  } else if (kSrc == kWords) {
    const uint32_t w =
        static_cast<const uint32_t*>(src)[row * (g.bs / 4) + b / 4];
    return (w >> (8 * (b % 4))) & 0xFFu;
  } else {
    const long long n = b >> 1;
    const int leg = static_cast<int>(b & 1);
    const int r = static_cast<int>(n % g.decim);
    const long long u = n / g.decim;
    return static_cast<const uint8_t*>(
        src)[((2LL * r + leg) * g.c + row) * g.n_out + u];
  }
}

__device__ inline float norm(unsigned v) {
  return (static_cast<float>(v) - 128.0f) * kScale;
}

template <int kSrc>
__global__ void __launch_bounds__(kThreads) rf_demod_kernel(
    const void* __restrict__ src, const float* __restrict__ h,
    const float* __restrict__ iq_tail, const float* __restrict__ prev_i,
    const float* __restrict__ prev_q, float* __restrict__ fm,
    float* __restrict__ iq_tail_out, float* __restrict__ prev_i_out,
    float* __restrict__ prev_q_out, Geom g) {
  extern __shared__ float smem[];
  const int d = g.decim;
  float* hs = smem;                     // [d, qmax]: hs[r][q] = h[s - qd - r]
  float* win[2];
  win[0] = hs + d * g.qmax;             // [d, lp] I window
  win[1] = win[0] + d * g.lp;           // [d, lp] Q window
  float* yi = win[1] + d * g.lp;        // [kThreads] decimated I
  float* yq = yi + kThreads;            // [kThreads] decimated Q
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kFm;      // the tile's first fm sample
  // ext = [tail || block] per leg; window slot l = v*d + r holds ext
  // sample e0 + l, and thread t computes decimated output m0 - 1 + t
  const long long e0 = static_cast<long long>(m0 - 1) * d;
  const int w_len = d * g.lp;
  const float* tail = iq_tail + row * 2 * g.s;

  for (int i = tid; i < d * g.qmax; i += kThreads) {
    const int a = (i % g.qmax) * d + i / g.qmax;
    hs[i] = a <= g.s ? h[g.s - a] : 0.0f;
  }

  // ---- the window, in polyphase order
  if (kSrc == kBytes) {
    const uint8_t* x = static_cast<const uint8_t*>(src) + row * g.bs;
    for (int b = tid; b < 2 * w_len; b += kThreads) {
      const int l = b >> 1;
      const int leg = b & 1;
      const long long e = e0 + l;
      float v = 0.0f;
      if (e >= 0 && e < g.s) {
        v = tail[leg * g.s + e];
      } else if (e >= g.s && e - g.s < g.n_in) {
        v = norm(x[2 * (e - g.s) + leg]);
      }
      win[leg][(l % d) * g.lp + l / d] = v;
    }
  } else if (kSrc == kWords) {
    // the tail and the slots outside the block, then the block's words
    for (int l = tid; l < w_len; l += kThreads) {
      const long long e = e0 + l;
      if (e >= g.s && e - g.s < g.n_in) continue;
      const bool in_tail = e >= 0 && e < g.s;
      const int slot = (l % d) * g.lp + l / d;
      win[0][slot] = in_tail ? tail[e] : 0.0f;
      win[1][slot] = in_tail ? tail[g.s + e] : 0.0f;
    }
    const uint32_t* x =
        static_cast<const uint32_t*>(src) + row * (g.bs / 4);
    const long long n_lo = e0 - g.s;               // raw sample of slot 0
    const long long w_lo = n_lo >= 0 ? n_lo / 2 : -((1 - n_lo) / 2);
    const long long n_words = g.bs / 4;
    for (long long w = w_lo + tid; 2 * w < n_lo + w_len; w += kThreads) {
      if (w < 0 || w >= n_words) continue;
      const uint32_t word = x[w];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long l = 2 * w + (k >> 1) - n_lo;
        if (l < 0 || l >= w_len) continue;
        win[k & 1][(l % d) * g.lp + l / d] = norm((word >> (8 * k)) & 0xFFu);
      }
    }
  } else {
    // plane p = 2r + leg, slot (r, v): ext e = e0 + v*d + r, plane sample
    // u = m0 - 1 + v - s/d (s % d == 0)
    const uint8_t* x = static_cast<const uint8_t*>(src);
    const int s_ph = g.s / d;
    for (int i = tid; i < 2 * w_len; i += kThreads) {
      const int p = i / g.lp;
      const int v = i % g.lp;
      const int r = p >> 1;
      const int leg = p & 1;
      const long long u = static_cast<long long>(m0) - 1 + v - s_ph;
      float val = 0.0f;
      if (u >= 0 && u < g.n_out) {
        val = norm(x[(static_cast<long long>(p) * g.c + row) * g.n_out + u]);
      } else if (u < 0 && u + s_ph >= 0) {
        val = tail[leg * g.s + (u + s_ph) * d + r];
      }
      win[leg][r * g.lp + v] = val;
    }
  }
  __syncthreads();

  // ---- the RF LPF on both legs: output m = sum_a h[s - a] ext[m*d + a]
  const int t = tid;
  const long long m = static_cast<long long>(m0) - 1 + t;
  float ai = 0.0f, aq = 0.0f;
  for (int r = 0; r < d && r <= g.s; ++r) {
    const int nq = (g.s - r) / d + 1;
    const float* hr = hs + r * g.qmax;
    const float* wi = win[0] + r * g.lp + t;
    const float* wq = win[1] + r * g.lp + t;
    for (int q = 0; q < nq; ++q) {
      ai = fmaf(hr[q], wi[q], ai);
      aq = fmaf(hr[q], wq[q], aq);
    }
  }
  if (m < 0) {  // the sample before the block: the carried one
    ai = prev_i[row];
    aq = prev_q[row];
  }
  yi[t] = ai;
  yq[t] = aq;
  __syncthreads();

  // ---- the differentiator demod, with the zero-power guard
  if (t >= 1 && m < g.n_out) {
    const float i = yi[t], q = yq[t];
    const float ip = yi[t - 1], qp = yq[t - 1];
    const float power = i * i + q * q;
    const float num = i * (q - qp) - q * (i - ip);
    fm[row * g.n_out + m] = power == 0.0f ? 0.0f : num / power;
    if (m == g.n_out - 1) {
      prev_i_out[row] = i;
      prev_q_out[row] = q;
    }
  }
  // ---- the next RF tail, [2, s], from the block's last 2s bytes
  if (blockIdx.y == gridDim.y - 1) {
    for (int j = tid; j < 2 * g.s; j += kThreads) {
      const int leg = j / g.s;
      const int kk = j % g.s;
      iq_tail_out[row * 2 * g.s + j] =
          norm(raw_byte<kSrc>(src, g, row, g.bs - 2LL * g.s + 2 * kk + leg));
    }
  }
}

template <int kSrc>
int launch(const void* src, const float* h, const float* iq_tail,
           const float* prev_i, const float* prev_q, float* fm,
           float* iq_tail_out, float* prev_i_out, float* prev_q_out,
           const Geom& g, cudaStream_t stream) {
  const size_t smem = smem_floats(g) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      rf_demod_kernel<kSrc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(g.c), (g.n_out + kFm - 1) / kFm);
  rf_demod_kernel<kSrc><<<grid, kThreads, smem, stream>>>(
      src, h, iq_tail, prev_i, prev_q, fm, iq_tail_out, prev_i_out,
      prev_q_out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one thread block takes at decimation
// `decim` with `k` taps (the same for all three sources).  The wrappers
// check it against the card's 227 KB before a launch.
extern "C" long long dy4_frontend_rf_smem(int decim, int k) {
  return static_cast<long long>(smem_floats(make_geom(1, 2LL * decim, decim,
                                                      k)) * sizeof(float));
}

// B11 (source 0), B12 (source 1), B13 (source 2).  `src`: iq_u8 [c, bs]
// u8, the phase planes [2*decim, c, bs/2/decim] u8, or the words
// [c, bs/4] int32.  h [k], iq_tail and iq_tail_out [c, 2, k-1],
// prev_i/prev_q and their outputs [c], fm [c, bs/2/decim], all float32
// and contiguous.  The caller guarantees bs % (2*decim) == 0, bs/2 >= k-1,
// and for source 1 (k-1) % decim == 0, for source 2 bs % 4 == 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dy4_frontend_rf(int source, const void* src, const float* h,
                               const float* iq_tail, const float* prev_i,
                               const float* prev_q, float* fm,
                               float* iq_tail_out, float* prev_i_out,
                               float* prev_q_out, long long c, long long bs,
                               int decim, int k, void* stream) {
  if (c <= 0) return 0;
  const Geom g = make_geom(c, bs, decim, k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (source) {
    case kBytes:
      return launch<kBytes>(src, h, iq_tail, prev_i, prev_q, fm, iq_tail_out,
                            prev_i_out, prev_q_out, g, st);
    case kPlanes:
      return launch<kPlanes>(src, h, iq_tail, prev_i, prev_q, fm,
                             iq_tail_out, prev_i_out, prev_q_out, g, st);
    case kWords:
      return launch<kWords>(src, h, iq_tail, prev_i, prev_q, fm, iq_tail_out,
                            prev_i_out, prev_q_out, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
