"""Build a CUDA source of ``dy4tpu_torch/csrc`` for the host, to run its
kernels on the CPU.

The card's compiler is not here, so the tests that hold a kernel's own
code to its plain version build the ``.cu`` file with g++ through a shim:
the CUDA qualifiers become nothing, a launch ``kernel<<<grid, threads,
smem, stream>>>(args)`` runs its blocks one after another with one
``std::thread`` per CUDA thread, ``__syncthreads`` is a ``std::barrier``
of the block, a named barrier (``bar.sync id, count``) a ``std::barrier``
of ``count`` threads, and the round-to-nearest intrinsics are the host's
IEEE operations (``__fmaf_rn`` is ``std::fma``, ``__int_as_float`` a
copy of the bits).  Each test file gives the
regular-expression rewrites that turn its source's inline assembly and
launch into calls of the shim.
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
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
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
inline void __syncthreads() { g_bar->arrive_and_wait(); }
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


def build_rational(out: Path, lib: str, names) -> ctypes.CDLL:
    """The ``csrc/<name>.cu`` files of ``names`` (kernels over
    ``rational.cuh``) built for the host into ``out``/``lib``."""
    csrc = Path(__file__).resolve().parents[1] / "dy4tpu_torch" / "csrc"
    sources = {"rational.cuh": rewrite(
        (csrc / "rational.cuh").read_text(), "csrc/rational.cuh",
        RATIONAL_REWRITES)}
    for name in names:
        sources[f"{name}.cpp"] = (csrc / f"{name}.cu").read_text()
    return build(out, lib, sources)
