// Device helpers of the ordered compactions: csrc/compact.cu (K4 and K8)
// and csrc/compact_exp.cu (K10, the compaction rig's kernel).
//
// Both find a tile's output offset by a chained scan with decoupled
// look-back: each tile publishes its set-entry count (flag 1) in a 64-bit
// status word, then one warp sums its predecessors' words 32 at a time,
// back to the first that holds an inclusive prefix (flag 2), and publishes
// its own inclusive prefix.  Flag and value share the word, written with
// st.release and read with ld.acquire, so a reader never sees a flag
// without its value.  Tiles are taken in ticket order, so every tile a
// look-back waits on belongs to a block that already runs.
//
// _build.py hashes this header with the sources, so an edit rebuilds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cgx {

constexpr unsigned long long kFlagAgg = 1ull << 32;     // the tile's count
constexpr unsigned long long kFlagPrefix = 2ull << 32;  // its inclusive prefix

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// bit t set iff byte t of w is non-zero
__device__ __forceinline__ unsigned nz4(unsigned w) {
  const unsigned v = __vcmpne4(w, 0u);
  return ((v >> 7) & 1u) | ((v >> 14) & 2u) | ((v >> 21) & 4u) |
         ((v >> 28) & 8u);
}

// bit t set iff byte t of the 16 is non-zero
__device__ __forceinline__ unsigned nz16(uint4 v) {
  return nz4(v.x) | (nz4(v.y) << 4) | (nz4(v.z) << 8) | (nz4(v.w) << 12);
}

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The exclusive prefix of tile b > 0: called by one whole warp after tile
// b published its count; every lane returns it.  Lane l reads predecessor
// j - l, so lane 0 holds the nearest; the warp spins until all 32 have
// published, then stops at the nearest inclusive prefix among them.
__device__ __forceinline__ int lookback(const unsigned long long* status,
                                        int b, int lane) {
  int excl = 0;
  for (int j = b - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long v;
    do {
      v = idx >= 0 ? ld_acquire(&status[idx]) : kFlagPrefix;
    } while (__any_sync(0xffffffffu, (v >> 32) == 0));
    const unsigned pm = __ballot_sync(0xffffffffu, (v >> 32) == 2);
    const int val = (int)(unsigned)(v & 0xffffffffu);
    if (pm) {
      const int k = __ffs(pm) - 1;
      return excl + __reduce_add_sync(0xffffffffu, lane <= k ? val : 0);
    }
    excl += __reduce_add_sync(0xffffffffu, val);
  }
}

}  // namespace cgx
