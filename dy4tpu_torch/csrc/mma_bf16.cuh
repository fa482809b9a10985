// Hopper's bf16 tensor cores through warp-level mma.sync, for B1 / B6's
// "default" / "high" path (frontend.cu, kBf16): dy4tpu's bf16 MXU dots
// (frontend_pallas.py _kernel_front_full, _band_stages) as banded
// Toeplitz products.
//
// A decimating FIR y[m] = sum_a h'[a] x[m*D + a] (a <= S) over N = 8
// consecutive outputs m0..m0+7 is the product of the window row
// x[m0*D + j], j < 7*D + S + 1, with the Toeplitz matrix H[j][n] =
// h'[j - n*D] (zero off the band).  One m16n8k16 MMA takes 16 such rows
// (16 groups of 8 outputs: 128 outputs) against 16 rows of H, so an
// output's sum runs in k-steps of 16 window samples; the products are
// exact in float32 (bf16 x bf16) and the tensor core sums them into a
// float32 accumulator.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane = 4*g + t
// (groupID g = lane >> 2, threadID_in_group t = lane & 3); each 32-bit
// register holds two bf16, the lower k (or column) in the low half.
//   A (16 x 16, row-major): a0 = (row g,   k 2t, 2t+1)
//                           a1 = (row g+8, k 2t, 2t+1)
//                           a2 = (row g,   k 2t+8, 2t+9)
//                           a3 = (row g+8, k 2t+8, 2t+9)
//   B (16 x 8, "col"):      b0 = (k 2t, 2t+1;   column g)
//                           b1 = (k 2t+8, 2t+9; column g)
//   C, D (16 x 8, f32):     d0, d1 = (row g, columns 2t, 2t+1)
//                           d2, d3 = (row g+8, columns 2t, 2t+1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace tc {

constexpr int kM = 16;     // rows of an MMA: groups of 8 outputs
constexpr int kN = 8;      // outputs a row (columns of H)
constexpr int kK = 16;     // window samples a k-step
constexpr int kUnit = kM * kN;   // outputs one MMA makes

// k-steps of a Toeplitz product over rows of 8 outputs at decimation
// `decim` through `taps` taps: the row's 7*decim + taps samples, padded
// to 16.
__host__ __device__ inline int ksteps(int decim, int taps) {
  return (7 * decim + taps + kK - 1) / kK;
}

// d += A B on the tensor cores: m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The element offset of the row lane `lane` gives ldsm_x4 in a 16 x 16
// A tile whose rows are `stride` elements apart: row (lane & 7) + 8 *
// ((lane >> 3) & 1), columns from 8 * (lane >> 4).
__host__ __device__ inline int ldsm_row(int lane, int stride) {
  return stride * ((lane & 7) + 8 * ((lane >> 3) & 1)) + 8 * (lane >> 4);
}

// The A fragment of a 16 x 16 bf16 tile from shared memory, each lane at
// its ldsm_row (16-byte aligned): r[i] comes out as a_i above.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// bf16 x (round to nearest even) as its 16 bits.
__device__ __forceinline__ unsigned bf16_bits(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<const unsigned short*>(&b);
}

// Two bf16 in one register, lo in the low half.
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  return bf16_bits(lo) | bf16_bits(hi) << 16;
}

// Bytes 0 and 2 (leg 0, I) or 1 and 3 (leg 1, Q) of a word of two
// interleaved u8 I/Q samples as the bf16 pair (b - 128): each byte into
// the mantissa of 2^23, 2^23 + 128 off (exact), and the float32 values'
// high halves, which hold every bit of an integer below 2^8, packed.
__device__ __forceinline__ unsigned u8_leg_pair(unsigned w, int leg) {
  const float lo = __int_as_float(static_cast<int>(
                       __byte_perm(w, 0x4B000000u, 0x7440u + leg))) -
                   8388736.0f;
  const float hi = __int_as_float(static_cast<int>(
                       __byte_perm(w, 0x4B000000u, 0x7442u + leg))) -
                   8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// The B fragment of lane `lane` at k-step kk of the Toeplitz matrix
// H[j][n] = tap(j - n*decim) for 0 <= j - n*decim < taps, else 0; `tap`
// returns the float32 tap, rounded to bf16 here.  The k-step's k index
// stands for window sample 16 kk + k; kQuad: the k pairs 2t, 2t+1 and
// 2t+8, 2t+9 stand for samples 4t, 4t+1 and 4t+2, 4t+3 instead (a sum
// over a k-step does not care which sample stands where, as long as A
// and B agree), so that a lane's four A samples of a row are adjacent.
template <bool kQuad = false, class Tap>
__device__ inline uint2 toeplitz_frag(const Tap& tap, int taps, int decim,
                                      int kk, int lane) {
  const int n = lane >> 2;
  const int t = lane & 3;
  const int j = kK * kk + (kQuad ? 4 : 2) * t - n * decim;
  const int hi = kQuad ? 2 : 8;
  auto at = [&](int a) { return a >= 0 && a < taps ? tap(a) : 0.0f; };
  return make_uint2(pack(at(j), at(j + 1)), pack(at(j + hi), at(j + hi + 1)));
}

}  // namespace tc
