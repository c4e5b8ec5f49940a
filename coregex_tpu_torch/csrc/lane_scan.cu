// Lane-walk kernels K1-K3 and K9: the corpus splits into L lanes of T bytes
// and each lane walks its bytes through a packed transition table.
//
// Replaces four Pallas kernels of the JAX package:
//   K1 count_scan.py:_count_kernel  value = delta*32 + emit
//   K2 span_scan.py:_span_kernel    value = delta*32 + (commits<<2 | first<<1 | flag)
//   K3 flag_scan.py:_flag_kernel    value = delta*32 + (interf<<1 | flag), symbols
//                                   index columns directly
//   K9 pallas_scan.py:_kernel       value = delta*32 + match: the chunked DFA
//                                   match scan (the TPU kernel reads a
//                                   4-byte class per corpus byte; here the
//                                   word tiles and the byte map, as K1)
// The TPU kernels walk a select tree over a row/column-merged table because
// Mosaic has no dynamic gather; here the full packed [S, NSEG] table sits in
// shared memory and each byte costs one shared-memory load.
//
// What bounds it on an H100: the per-byte step is a dependent chain
// (state -> table load -> state), so one lane runs at one shared-memory
// latency per byte.  plan_geometry caps the corpus at 8192 lanes, about 62
// threads per SM, far too few to hide that latency; widening the lanes is
// later work.  Device-memory traffic is one read of the word tiles (plus
// n/16 bytes of flag words for K2/K3): adjacent lanes read adjacent words of
// the time-major [T4, L] layout, so each warp load is one 128-byte line.
// Each thread issues the 8 loads of a 32-position group before stepping
// through them, which keeps several loads in flight per thread.
//
// Layouts (int32, little-endian bytes within a word):
//   tiles   [T4, L]     word t of lane l = bytes l*T + 4t .. l*T + 4t + 3
//   flagw   [T4/8, L]   bit 4*(t%8)+k of word t/8 = position 4t+k of the lane
//   counts, exits, sync, entries, offsets, limits  [L]
//   K9: counts = set flags of the lane, aux [L] = the lane-local position of
//   its last set flag (-1 if none), so callers need no pass over the words
// Warmup: a lane first steps the previous lane's last W4 words (lane 0 reads
// lane L-1's, which its offset of W skips), skipping warmup position p when
// p < offsets[l]; `sync` is the state after warmup, `exits` the state after
// the lane.  Positions p >= limits[l] leave the state frozen and emit nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kCount = 0, kSpan = 1, kFlag = 2, kMatch = 3 };

template <int MODE>
__global__ void lane_walk_kernel(
    const int32_t* __restrict__ packed, int nseg, int ntbl,
    const int32_t* __restrict__ segmap,
    const int32_t* __restrict__ tiles, int T4, int L, int W4,
    const int32_t* __restrict__ entries, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ limits, int32_t* __restrict__ counts,
    int32_t* __restrict__ exits, int32_t* __restrict__ sync,
    int32_t* __restrict__ flagw, int32_t* __restrict__ aux) {
  extern __shared__ int32_t smem[];
  int32_t* tbl = smem;
  int32_t* seg = smem + ntbl;
  for (int i = threadIdx.x; i < ntbl; i += blockDim.x) tbl[i] = packed[i];
  if (MODE != kFlag) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) seg[i] = segmap[i];
  }
  __syncthreads();

  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;

  int s = entries[l];
  const int off = offsets[l];
  const int prev = (l == 0) ? L - 1 : l - 1;
  for (int tw = 0; tw < W4; ++tw) {
    const uint32_t w = (uint32_t)tiles[(size_t)(T4 - W4 + tw) * L + prev];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = (w >> (8 * k)) & 255;
      const int c = (MODE == kFlag) ? b : seg[b];
      if (tw * 4 + k >= off) s = tbl[s * nseg + c] >> 5;
    }
  }
  sync[l] = s;

  const int lim = limits[l];
  int cnt = 0, last = -1;
  for (int g = 0; g < T4 / 8; ++g) {
    uint32_t fw = 0, gw = 0;
    if (g * 32 < lim) {
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = (uint32_t)tiles[(size_t)(g * 8 + j) * L + l];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = g * 32 + j * 4 + k;
          if (p < lim) {
            const int b = (w[j] >> (8 * k)) & 255;
            const int c = (MODE == kFlag) ? b : seg[b];
            const int v = tbl[s * nseg + c];
            if (MODE == kCount) {
              cnt += v & 31;
            } else if (MODE == kSpan) {
              cnt += (v >> 2) & 7;
              fw |= (uint32_t)(v & 1) << (j * 4 + k);
              gw |= (uint32_t)((v >> 1) & 1) << (j * 4 + k);
            } else if (MODE == kFlag) {
              cnt += (v >> 1) & 1;
              fw |= (uint32_t)(v & 1) << (j * 4 + k);
            } else {
              fw |= (uint32_t)(v & 1) << (j * 4 + k);
            }
            s = v >> 5;
          }
        }
      }
    } else if (MODE == kCount) {
      break;
    }
    if (MODE == kMatch && fw != 0) {
      cnt += __popc(fw);
      last = g * 32 + 31 - __clz((int)fw);
    }
    if (MODE != kCount) flagw[(size_t)g * L + l] = (int32_t)fw;
    if (MODE == kSpan) aux[(size_t)g * L + l] = (int32_t)gw;
  }
  counts[l] = cnt;
  exits[l] = s;
  if (MODE == kMatch) aux[l] = last;
}

constexpr int kThreads = 128;

template <int MODE>
int launch(const int32_t* packed, int S, int nseg, const int32_t* segmap,
           const int32_t* tiles, int T4, int L, int W4, const int32_t* entries,
           const int32_t* offsets, const int32_t* limits, int32_t* counts,
           int32_t* exits, int32_t* sync, int32_t* flagw, int32_t* aux,
           void* stream) {
  const int ntbl = S * nseg;
  const size_t smem = (size_t)(ntbl + (MODE == kFlag ? 0 : 256)) * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      lane_walk_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (L + kThreads - 1) / kThreads;
  lane_walk_kernel<MODE><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      packed, nseg, ntbl, segmap, tiles, T4, L, W4, entries, offsets, limits,
      counts, exits, sync, flagw, aux);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cgx_lane_count(const int32_t* packed, int S, int nseg, const int32_t* segmap,
                   const int32_t* tiles, int T4, int L, int W4,
                   const int32_t* entries, const int32_t* offsets,
                   const int32_t* limits, int32_t* counts, int32_t* exits,
                   int32_t* sync, void* stream) {
  return launch<kCount>(packed, S, nseg, segmap, tiles, T4, L, W4, entries,
                        offsets, limits, counts, exits, sync, nullptr, nullptr,
                        stream);
}

int cgx_lane_span(const int32_t* packed, int S, int nseg, const int32_t* segmap,
                  const int32_t* tiles, int T4, int L, int W4,
                  const int32_t* entries, const int32_t* offsets,
                  const int32_t* limits, int32_t* counts, int32_t* exits,
                  int32_t* sync, int32_t* flagw, int32_t* firstw, void* stream) {
  return launch<kSpan>(packed, S, nseg, segmap, tiles, T4, L, W4, entries,
                       offsets, limits, counts, exits, sync, flagw, firstw,
                       stream);
}

int cgx_lane_flag(const int32_t* packed, int S, int nseg, const int32_t* tiles,
                  int T4, int L, int W4, const int32_t* entries,
                  const int32_t* offsets, const int32_t* limits,
                  int32_t* counts, int32_t* exits, int32_t* sync,
                  int32_t* flagw, void* stream) {
  return launch<kFlag>(packed, S, nseg, nullptr, tiles, T4, L, W4, entries,
                       offsets, limits, counts, exits, sync, flagw, nullptr,
                       stream);
}

int cgx_lane_match(const int32_t* packed, int S, int nseg, const int32_t* segmap,
                   const int32_t* tiles, int T4, int L, int W4,
                   const int32_t* entries, const int32_t* offsets,
                   const int32_t* limits, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* flagw, int32_t* last, void* stream) {
  return launch<kMatch>(packed, S, nseg, segmap, tiles, T4, L, W4, entries,
                        offsets, limits, counts, exits, sync, flagw, last,
                        stream);
}

const char* cgx_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
