// Device helpers of the split walks' repair passes: csrc/lane_scan.cu (K1,
// K2, K3 and K9) and csrc/needle_scan.cu (K7).  Both split a lane of T
// bytes into k sub-lanes of Tk = T/k bytes and count a pass's walkers so
// that a pass that walks nothing ends the host loop.
//
// _build.py hashes this header with the sources, so an edit rebuilds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cgx {

// Sub-lane j's share of its lane's limit lim: the live bytes of
// [j*Tk, (j+1)*Tk), 0 for a sub-lane past the corpus end.
__device__ __forceinline__ int sub_limit(int lim, int j, int Tk) {
  return min(max(lim - j * Tk, 0), Tk);
}

// Adds this warp's walking threads to *walked, one atomic per warp.
__device__ __forceinline__ void count_walker(int32_t* walked) {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(walked, __popc(m));
}

}  // namespace cgx
