"""Build a CUDA source of ``dy4tpu_torch/csrc`` for the host, to run its
kernels on the CPU.

The card's compiler is not here, so the tests that hold a kernel's own
code to its plain version build the ``.cu`` file with g++ through a shim:
the CUDA qualifiers become nothing, a launch ``kernel<<<grid, threads,
smem, stream>>>(args)`` runs its blocks one after another with one
``std::thread`` per CUDA thread, ``__syncthreads`` is a ``std::barrier``
of the block, a named barrier (``bar.sync id, count``) a ``std::barrier``
of ``count`` threads (``bar.arrive`` an arrival on it that does not
wait), and the round-to-nearest intrinsics are the host's
IEEE operations (``__fmaf_rn`` is ``std::fma``, ``__int_as_float`` a
copy of the bits, ``__funnelshift_r`` a shift of the 64-bit pair,
``__float2bfloat16_rn`` a round to nearest even of the bits,
``__byte_perm`` a pick of bytes, ``__umulhi`` the high half of a 64-bit
product).  The warp-wide tensor-core instructions
of ``csrc/mma_bf16.cuh`` (``MMA_REWRITES``) exchange through the warp:
each of its 32 threads posts its fragments (or its row address) and
waits at a barrier of the warp, then computes its own part from the
whole warp's by the PTX fragment layout (groupID = lane >> 2,
threadID_in_group = lane % 4), and waits again before the next;
``__shfl_down_sync`` exchanges the same way.  Each
test file gives the regular-expression rewrites that turn its source's
inline assembly and launch into calls of the shim.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return static_cast<unsigned>(
      ((static_cast<unsigned long long>(hi) << 32) | lo) >> (shift & 31));
}
using std::min;
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
// byte k of the result: byte (selector nibble k) of b:a (a bytes 0-3)
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned sel) {
  const unsigned long long ab = (static_cast<unsigned long long>(b) << 32) | a;
  unsigned r = 0;
  for (int k = 0; k < 4; ++k)
    r |= static_cast<unsigned>((ab >> (8 * ((sel >> (4 * k)) & 7))) & 0xFF)
         << (8 * k);
  return r;
}
// cuda_bf16.h's conversions: round to nearest even (NaN kept a NaN)
struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 64)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
struct dim3 { unsigned x, y, z; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local unsigned char* g_smem;
inline thread_local std::barrier<>* g_bar;
// the named barriers of one block, each made by its first arrival
struct NamedBars {
  std::mutex m;
  std::map<int, std::unique_ptr<std::barrier<>>> bars;
};
inline thread_local NamedBars* g_named;
inline void named_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(g_named->m);
    auto& slot = g_named->bars[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    b = slot.get();
  }
  b->arrive_and_wait();
}
inline void named_arrive(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(g_named->m);
    auto& slot = g_named->bars[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    b = slot.get();
  }
  (void)b->arrive();
}
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __threadfence_block() {}
// one warp's exchange for mma.sync and ldmatrix
struct WarpX {
  std::barrier<> bar{32};
  unsigned a[32][4];
  unsigned b[32][2];
  const unsigned char* p[32];
  float v[32];
};
inline thread_local WarpX* g_warps;
inline float bf16_half(unsigned r, int hi) {
  const uint32_t u = (hi ? r >> 16 : r & 0xFFFFu) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += A B: lane
// 4g + t holds A (rows g, g+8; k 2t, 2t+1 and +8), B (k 2t, 2t+1 and +8;
// column g) and D (row g, g+8; columns 2t, 2t+1); each sum in k order
inline void host_mma(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  WarpX& w = g_warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b.x;
  w.b[lane][1] = b.y;
  w.bar.arrive_and_wait();
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = (lane >> 2) + 8 * (i >> 1), col = 2 * (lane & 3) + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 16; ++k)
      acc += bf16_half(w.a[4 * (row & 7) + ((k & 7) >> 1)]
                          [(row >> 3) + 2 * (k >> 3)], k & 1) *
             bf16_half(w.b[4 * col + ((k & 7) >> 1)][k >> 3], k & 1);
    out[i] = acc;
  }
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
// __shfl_down_sync over the whole warp: lane l gets lane l + off's v, or
// its own where l + off is past the warp
inline float __shfl_down_sync(unsigned, float v, int off) {
  WarpX& w = g_warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  w.v[lane] = v;
  w.bar.arrive_and_wait();
  const float got = lane + off < 32 ? w.v[lane + off] : v;
  w.bar.arrive_and_wait();
  return got;
}
// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lane l gives row l % 8 of
// matrix l / 8; r[i] = the word at row lane / 4, column pair lane % 4 of
// matrix i
inline void host_ldsm_x4(unsigned (&r)[4], const void* p) {
  WarpX& w = g_warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  w.p[lane] = static_cast<const unsigned char*>(p);
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i)
    std::memcpy(&r[i], w.p[8 * i + (lane >> 2)] + 4 * (lane & 3), 4);
  w.bar.arrive_and_wait();
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 1
};
template <class T> cudaError_t cudaFuncSetAttribute(T, int, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 0;
  return 0;
}
inline dim3 grid_of(dim3 d) { return d; }
template <class T> dim3 grid_of(T x) { return {unsigned(x), 1, 1}; }
// blocks one after another (x fastest), each with a thread per CUDA thread
template <class K, class G, class... A>
void emulate(K kernel, G grid, int threads, int smem, const A&... a) {
  if (smem > 232448 || threads > 1024) abort();
  const dim3 g = grid_of(grid);
  for (unsigned by = 0; by < g.y; ++by)
    for (unsigned bx = 0; bx < g.x; ++bx) {
      std::vector<unsigned char> buf(smem);
      std::barrier<> bar(threads);
      NamedBars named;
      std::vector<WarpX> warps((threads + 31) / 32);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, bx, by, t] {
          threadIdx = {unsigned(t), 0, 0};
          blockIdx = {bx, by, 0};
          blockDim = {unsigned(threads), 1, 1};
          gridDim = g;
          g_smem = buf.data();
          g_bar = &bar;
          g_named = &named;
          g_warps = warps.data();
          kernel(a...);
        });
      for (auto& t : ts) t.join();
    }
}
"""

# the launch of a kernel on the stream of an entry point
LAUNCH = (r"kernel<<<(.*?), (.*?), (.*?),\s*static_cast<cudaStream_t>"
          r"\(stream\)>>>\((.*?)\);", r"emulate(kernel, \1, \2, \3, \4);")


def rewrite(src: str, name: str, rewrites) -> str:
    """``src`` (the file ``name``) with each (pattern, replacement) of
    ``rewrites`` applied; each must match.  No assembly or launch may be
    left."""
    for pattern, repl in rewrites:
        src, count = re.subn(pattern, repl, src, flags=re.S)
        assert count, f"{name} no longer holds {pattern!r}"
    assert "asm" not in src and "<<<" not in src, name
    return src


def build(out: Path, lib: str, sources: dict[str, str]) -> ctypes.CDLL:
    """Write ``shim.h`` and ``sources`` (file name -> text; the ``.cpp``
    files are compiled, the rest included) into ``out`` and build them
    with g++ into ``lib``; skips when there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build a CUDA source for the host")
    (out / "shim.h").write_text(SHIM)
    for name, text in sources.items():
        (out / name).write_text(text)
    path = out / lib
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-Wno-unknown-pragmas", "-o", str(path)]
        + [str(out / n) for n in sources if n.endswith(".cpp")],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
    return ctypes.CDLL(str(path))


# csrc/rational.cuh's named barrier, dynamic shared memory and launch
RATIONAL_REWRITES = (
    (r"#include <cuda_runtime\.h>", '#include "shim.h"'),
    (r'asm volatile\("bar\.sync 1, %0;\\n" ::"r"\(n\) : "memory"\);',
     "named_sync(1, n);"),
    (r"extern __shared__ __align__\(16\) float smem\[\];",
     "float* smem = reinterpret_cast<float*>(g_smem);"),
    LAUNCH,
)


# csrc/cp_async.cuh's copies as plain copies, commit and wait as nothing
CP_ASYNC_REWRITES = (
    (r"#include <cuda_runtime\.h>", '#include "shim.h"'),
    (r'asm volatile\("cp\.async\.cg.*?\);', "memcpy(dst, src, 16);"),
    (r'asm volatile\("cp\.async\.ca.*?\);', "memcpy(dst, src, 4);"),
    (r'asm volatile\("cp\.async\.commit_group.*?\);', ";"),
    (r'asm volatile\("cp\.async\.wait_group.*?\);', ";"),
    (r"const unsigned d = static_cast<unsigned>\("
     r"__cvta_generic_to_shared\(dst\)\);", ""),
)


def cp_async_header() -> str:
    """``csrc/cp_async.cuh`` for the host (``CP_ASYNC_REWRITES``)."""
    csrc = Path(__file__).resolve().parents[1] / "dy4tpu_torch" / "csrc"
    return rewrite((csrc / "cp_async.cuh").read_text(), "csrc/cp_async.cuh",
                   CP_ASYNC_REWRITES)


# csrc/mma_bf16.cuh's mma.sync and ldmatrix as the shim's warp exchanges
MMA_REWRITES = (
    (r"#include <cuda_runtime\.h>", '#include "shim.h"'),
    (r'asm volatile\(\s*"mma\.sync.*?\);', "host_mma(d, a, b);"),
    (r"const unsigned s = static_cast<unsigned>\("
     r"__cvta_generic_to_shared\(p\)\);", ""),
    (r'asm volatile\(\s*"ldmatrix\.sync.*?\);', "host_ldsm_x4(r, p);"),
)


def mma_header() -> str:
    """``csrc/mma_bf16.cuh`` for the host (``MMA_REWRITES``)."""
    csrc = Path(__file__).resolve().parents[1] / "dy4tpu_torch" / "csrc"
    return rewrite((csrc / "mma_bf16.cuh").read_text(), "csrc/mma_bf16.cuh",
                   MMA_REWRITES)


# csrc/rational_tc.cuh's ring barriers, dynamic shared memory and launch
RATIONAL_TC_REWRITES = (
    (r'asm volatile\("bar\.sync %0, %1;\\n" ::"r"\(id\), "r"\(n\) : '
     r'"memory"\);', "named_sync(id, n);"),
    (r'asm volatile\("bar\.arrive %0, %1;\\n" ::"r"\(id\), "r"\(n\) : '
     r'"memory"\);', "named_arrive(id, n);"),
) + RATIONAL_REWRITES[2:]


def build_rational(out: Path, lib: str, names) -> ctypes.CDLL:
    """The ``csrc/<name>.cu`` files of ``names`` (kernels over
    ``rational.cuh`` and ``rational_tc.cuh``) built for the host into
    ``out``/``lib``."""
    csrc = Path(__file__).resolve().parents[1] / "dy4tpu_torch" / "csrc"
    sources = {"rational.cuh": rewrite(
        (csrc / "rational.cuh").read_text(), "csrc/rational.cuh",
        RATIONAL_REWRITES),
        "rational_tc.cuh": rewrite(
            (csrc / "rational_tc.cuh").read_text(), "csrc/rational_tc.cuh",
            RATIONAL_TC_REWRITES),
        "mma_bf16.cuh": mma_header()}
    for name in names:
        sources[f"{name}.cpp"] = (csrc / f"{name}.cu").read_text()
    return build(out, lib, sources)


# csrc/frontend.cu's corr epilogue's device calls: blocks run one after
# another here, so the ticket and the fenced reads are plain ones
FRONTEND_STUBS = """
inline int atomicAdd(int* p, int v) { const int o = *p; *p += v; return o; }
inline void __threadfence() {}
inline float __ldcg(const float* p) { return *p; }
inline cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t) {
  return 0;
}
"""
FRONTEND_REWRITES = (
    (r'#include "rf_stage\.cuh"', '#include "rf_stage.cuh"\n'
     + FRONTEND_STUBS),
    (r"extern __shared__ float4 smem4\[\];",
     "float4* smem4 = reinterpret_cast<float4*>(g_smem);"),
    (r"frontend_full_kernel<kRds, kCorr, kBf16><<<grid, kThreads, "
     r"smem, stream>>>\((.*?)\);",
     r"emulate(frontend_full_kernel<kRds, kCorr, kBf16>, grid, "
     r"kThreads, smem, \1);"),
    (r"frontend_if_kernel<kRds, kBf16><<<grid, kThreads, smem, "
     r"stream>>>\((.*?)\);",
     r"emulate(frontend_if_kernel<kRds, kBf16>, grid, kThreads, "
     r"smem, \1);"),
    (r"#include <cuda_runtime\.h>", '#include "shim.h"'),
)


def rf_stage_header() -> str:
    """``csrc/rf_stage.cuh`` for the host."""
    csrc = Path(__file__).resolve().parents[1] / "dy4tpu_torch" / "csrc"
    return rewrite((csrc / "rf_stage.cuh").read_text(), "csrc/rf_stage.cuh",
                   ((r"#include <cuda_runtime\.h>", '#include "shim.h"'),))


def build_frontend(out: Path) -> ctypes.CDLL:
    """``csrc/frontend.cu`` (B1, B1-corr, B6) built for the host into
    ``out``, with its headers: the entry points ``dy4_frontend_full``,
    ``dy4_frontend_full_corr``, ``dy4_frontend_if`` (the wrappers'
    argument types) and ``dy4_frontend_smem``."""
    from dy4tpu_torch.ops import frontend_cuda as fc
    csrc = Path(__file__).resolve().parents[1] / "dy4tpu_torch" / "csrc"
    src = rewrite((csrc / "frontend.cu").read_text(), "csrc/frontend.cu",
                  FRONTEND_REWRITES)
    so = build(out, "libfrontend_host.so",
               {"rf_stage.cuh": rf_stage_header(),
                "cp_async.cuh": cp_async_header(),
                "mma_bf16.cuh": mma_header(), "frontend.cpp": src})
    for name, args in (("dy4_frontend_full", fc._ARGS),
                       ("dy4_frontend_full_corr", fc._CORR_ARGS),
                       ("dy4_frontend_if", fc._IF_ARGS)):
        getattr(so, name).argtypes = args
        getattr(so, name).restype = ctypes.c_int
    so.dy4_frontend_smem.argtypes = [ctypes.c_int] * 8
    so.dy4_frontend_smem.restype = ctypes.c_longlong
    return so
