// Asynchronous copies from device memory into shared memory (cp.async):
// a copy is issued, runs while the block computes, and is waited for by
// its commit group.  The kernels that stage their input ahead of their
// arithmetic (channelizer.cu, fir.cu, pll.cu) share these.

#pragma once

#include <cuda_runtime.h>

namespace cpa {

// 16 bytes, through L2 only (both addresses 16-byte aligned)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 4 bytes, cached in L1 too (neighbouring copies share its lines)
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// the copies this thread issued since the last commit form a group
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group of this thread but the newest kPending has landed
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace cpa
