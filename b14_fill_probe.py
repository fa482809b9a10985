"""B14's window fill, four ways, on the card: the 4-byte polyphase copies
``csrc/fir.cu`` takes against 16-byte copies.

Run from the root of a checkout on a machine with a CUDA device and nvcc::

    python3 b14_fill_probe.py

It builds one probe kernel, written here, with ``csrc/fir.cu``'s grid,
ring and MACs (``rf_stage.cuh``'s ``mac4``, ``cp_async.cuh``'s copies) and
four fills of a pass window:

  0. ``polyphase4``: 4-byte copies straight into the polyphase slots, the
     phase and slot stepped (``fir.cu``'s fill);
  1. ``natural4``: the same copies into natural order (wrong output: what
     the fill costs without the polyphase stepping);
  2. ``natural16``: 16-byte copies into natural order (wrong output: a
     floor for any 16-byte design);
  3. ``restage16``: 16-byte copies into a natural-order ring, then a
     stepped restage of each pass into one polyphase window (the 16-byte
     design; its output is right but for the first outputs of a row,
     whose halo it reads from the row and not from the state).

At mode 0's RF legs of 512 channels ([1024, 76800], K=101, D=10) and 128
of them, each fill under each plan of ``PLANS`` (tile, outputs a pass,
stages) is timed alone from a cold L2 (20 launches under
``torch.profiler``, each after a read of twice the L2), beside
``fir_cuda``'s own kernel under the same plan.  Prints the card's name
and power limit, one line a (fill, plan), then the numbers as one JSON
line.  Nothing of it is used by the port.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent
GEOMS = ((1024, 76800, 101, 10), (128, 76800, 101, 10))
PLANS = ((1024, 512, 1), (960, 480, 1), (1920, 512, 1), (1024, 512, 2),
         (1024, 256, 2), (512, 512, 1))
FILLS = ("polyphase4", "natural4", "natural16", "restage16")
CALLS = 20

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "cp_async.cuh"
#include "rf_stage.cuh"

constexpr int kThreads = 128;

struct G {
  long long n;
  int n_out, decim, s, nq, lp, tile, n_tiles, sub, stages, w, stage;
};

// pass window of ext samples [e0, e0 + w) of row xr (e0 >= s assumed but
// for a row's first pass, whose halo is read from the row, clamped)
template <int kFill>
__device__ void fill(float* buf, const G& g, const float* xr,
                     const float* x_lo, const float* x_hi, long long e0,
                     int tid) {
  const float* a = xr + (e0 - g.s);
  const bool inside = a >= x_lo && a + g.w + 4 <= x_hi;
  if (kFill == 0 || kFill == 1) {
    const int d = g.decim;
    int r = tid % d, slot = r * g.lp + tid / d;
    const int dr = kThreads % d, dslot = dr * g.lp + kThreads / d;
    for (int l = tid; l < g.w; l += kThreads) {
      const float* src = a + l;
      if (!inside) src = src < x_lo ? x_lo : src >= x_hi ? x_hi - 1 : src;
      cpa::copy4(buf + (kFill == 0 ? slot : l), src);
      r += dr;
      slot += dslot;
      if (r >= d) {
        r -= d;
        slot += 1 - d * g.lp;
      }
    }
  } else {
    const float* a0 = reinterpret_cast<const float*>(
        reinterpret_cast<uintptr_t>(a) & ~static_cast<uintptr_t>(15));
    const int chunks = (static_cast<int>(a - a0) + g.w + 3) / 4;
    for (int i = tid; i < chunks; i += kThreads) {
      const float* src = a0 + 4 * i;
      if (!inside) src = src < x_lo ? x_lo : src + 4 > x_hi ? x_hi - 4 : src;
      cpa::copy16(buf + 4 * i, src);
    }
  }
}

// a natural-order stage (from the 16-byte boundary at or below the
// window's first sample) into the polyphase window, stepped
__device__ void restage(float* win, const float* nat, const G& g,
                        const float* xr, long long e0, int tid) {
  const int d = g.decim;
  const float* a = xr + (e0 - g.s);
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(a) & 15) / 4);
  const int chunks = (shift + g.w + 3) / 4;
  int l = 4 * tid - shift;
  int r = (l + 4 * d) % d, v = (l + 4 * d) / d - 4;
  const int step = 4 * kThreads, dr = step % d, dv = step / d;
  for (int i = tid; i < chunks; i += kThreads) {
    const float4 q = *reinterpret_cast<const float4*>(nat + 4 * i);
    const float vals[4] = {q.x, q.y, q.z, q.w};
    int rr = r, vv = v;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (l + c >= 0 && l + c < g.w) win[rr * g.lp + vv] = vals[c];
      if (++rr == d) {
        rr = 0;
        ++vv;
      }
    }
    l += step;
    r += dr;
    v += dv;
    if (r >= d) {
      r -= d;
      ++v;
    }
  }
}

__device__ void wait_pending(int n) {
  if (n == 0) cpa::wait<0>(); else if (n == 1) cpa::wait<1>();
  else cpa::wait<2>();
}

template <int kFill>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const float* __restrict__ x, const float* __restrict__ h,
    float* __restrict__ y, G g, long long rows) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* ring = hs + g.decim * g.nq;
  float* win = ring + g.stages * g.stage;  // restage16's polyphase window
  const int d = g.decim, tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int m0 = blockIdx.y * g.tile;
  const int m1 = min(m0 + g.tile, g.n_out);
  const int passes = (m1 - m0 + g.sub - 1) / g.sub;
  const float* xr = x + row * g.n;
  const float* x_hi = x + rows * g.n;
  rf::Geometry rg;
  rg.decim = d;
  rg.s_rf = g.s;
  rg.nq = g.nq;
  rf::load_taps<kThreads>(hs, rg, h, tid);
  const long long e_tile = static_cast<long long>(m0) * d;
  for (int p = 0; p < g.stages - 1; ++p) {
    if (p < passes)
      fill<kFill>(ring + p * g.stage, g, xr, x, x_hi,
                  e_tile + static_cast<long long>(p) * g.sub * d, tid);
    cpa::commit();
  }
  for (int p = 0; p < passes; ++p) {
    __syncthreads();
    const int q = p + g.stages - 1;
    if (q < passes)
      fill<kFill>(ring + (q % g.stages) * g.stage, g, xr, x, x_hi,
                  e_tile + static_cast<long long>(q) * g.sub * d, tid);
    cpa::commit();
    wait_pending(g.stages - 1);
    __syncthreads();
    const float* w = ring + (p % g.stages) * g.stage;
    if (kFill == 3) {
      restage(win, w, g, xr, e_tile + static_cast<long long>(p) * g.sub * d,
              tid);
      __syncthreads();
      w = win;
    }
    const int mp = m0 + p * g.sub;
    const int n_p = min(g.sub, m1 - mp);
    for (int t0 = rf::kR * tid; t0 < n_p; t0 += rf::kR * kThreads) {
      float acc[1][rf::kR] = {};
      for (int r = 0; r < d; ++r)
        rf::mac4<1>(hs + r * g.nq, 0, w + r * g.lp + t0, g.nq / 4, acc);
      for (int k = 0; k < rf::kR; ++k)
        if (t0 + k < n_p) y[row * g.n_out + mp + t0 + k] = acc[0][k];
    }
  }
}

template <int kFill>
int run(const float* x, const float* h, float* y, const G& g,
        long long rows, size_t smem, cudaStream_t st) {
  cudaFuncSetAttribute(probe_kernel<kFill>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  probe_kernel<kFill><<<dim3(rows, g.n_tiles), kThreads, smem, st>>>(
      x, h, y, g, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe(int fill, const float* x, const float* h, float* y,
                     long long rows, long long n, int decim, int k, int tile,
                     int sub, int stages, void* stream) {
  G g;
  g.n = n;
  g.n_out = static_cast<int>(n / decim);
  g.decim = decim;
  g.s = k - 1;
  g.nq = rf::round4(g.s / decim + 1);
  g.lp = rf::window_row(sub + g.nq);
  g.tile = tile;
  g.n_tiles = (g.n_out + tile - 1) / tile;
  g.sub = sub;
  g.stages = stages;
  g.w = decim * (sub + g.nq);
  const int natural = (g.w + 8 + 3) / 4 * 4;
  g.stage = fill == 0 ? decim * g.lp
                      : (natural > decim * g.lp ? natural : decim * g.lp);
  const size_t smem = 4 * (static_cast<size_t>(decim) * g.nq +
                           static_cast<size_t>(stages) * g.stage +
                           (fill == 3 ? static_cast<size_t>(decim) * g.lp
                                      : 0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fill) {
    case 0: return run<0>(x, h, y, g, rows, smem, st);
    case 1: return run<1>(x, h, y, g, rows, smem, st);
    case 2: return run<2>(x, h, y, g, rows, smem, st);
    default: return run<3>(x, h, y, g, rows, smem, st);
  }
}
"""


def text(ms: float | None) -> str:
    return "-" if ms is None else f"{ms:.4f}"


def _device_ms(fn, name: str, flush) -> float | None:
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if name in e.key
                and getattr(e, "device_time_total", 0.0) > 0]
        count = sum(e.count for e in mine)
        if count:
            return sum(e.device_time_total for e in mine) / count / 1e3
    return None


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("b14_fill_probe: no CUDA device")
    sys.path.insert(0, str(REPO))
    from dy4tpu_torch.ops import fir_cuda
    from dy4tpu_torch.runtime import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cu"
        src.write_text(SOURCE)
        lib = Path(tmp) / "libprobe.so"
        subprocess.run([kernels.find_nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC",
                        f"-I{kernels.CSRC}", "-o", str(lib), str(src)],
                       check=True)
        probe = ctypes.CDLL(str(lib)).probe
    probe.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                      + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    probe.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(0)
    flush = torch.empty(2 * getattr(props, "L2_cache_size", 50 * 2 ** 20),
                        dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    out = []
    for rows, n, k, d in GEOMS:
        x = torch.randn(rows, n, generator=gen, device=dev)
        h = torch.randn(k, generator=gen, device=dev)
        st = torch.randn(rows, k - 1, generator=gen, device=dev)
        ref, _ = fir_cuda.block_fir_decim_plain(x, h, st, d)
        y = torch.empty_like(ref)
        skip = (k - 1) // d + 1    # outputs whose halo reaches the state
        for tile, sub, stages in PLANS:
            plan = fir_cuda._fir_plan(n // d, d, k, rows=rows, tile=tile,
                                      sub=sub, stages=stages)
            ms = _device_ms(lambda: fir_cuda._launch(x, h, st, d, plan),
                            "fir_decim_kernel", flush)
            row = dict(rows=rows, n=n, k=k, d=d, tile=tile, sub=sub,
                       stages=stages, fir_cu_ms=ms)
            for i, name in enumerate(FILLS):
                def call(i=i):
                    assert probe(i, x.data_ptr(), h.data_ptr(),
                                 y.data_ptr(), rows, n, d, k, tile, sub,
                                 stages,
                                 torch.cuda.current_stream().cuda_stream
                                 ) == 0
                call()
                torch.cuda.synchronize()
                err = float((y - ref)[:, skip:].abs().max())
                row[f"{name}_ms"] = _device_ms(call, "probe_kernel", flush)
                row[f"{name}_err"] = err
            out.append(row)
            print(f"[{rows}, {n}] K={k} D={d}, tiles of {tile}, passes of "
                  f"{sub}, {stages} stage(s), alone from a cold L2, ms: "
                  f"fir.cu {text(ms)}; " + "; ".join(
                      f"{name} {text(row[name + '_ms'])} (err "
                      f"{row[name + '_err']:.2g})" for name in FILLS)
                  + f" ({smi})", flush=True)
    print(json.dumps({"device": smi, "b14_fill_probe": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
