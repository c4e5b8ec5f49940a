// K4: ordered stream compaction of a byte mask with 0-4 int32 payloads.
//
// Replaces the Pallas kernel coregex_tpu/ops/compact2.py:_make_kernel(R, npay)
// (launched by _compact_pay_call).  The TPU kernel runs its grid in order on
// one core, carrying the output offset from block to block and routing
// positions through a binary-weighted shift network on the VPU/MXU.  Blocks
// on Hopper run in no order, so the offset carry becomes three passes:
//   1. count   each block counts its set entries (__ballot_sync + __popc);
//   2. scan    one block turns the per-block counts into exclusive offsets,
//              writes the total and the ok flag (total <= cap);
//   3. scatter each block walks its chunk again in order, ranks set entries
//              within each warp by popcount of the lower-lane ballot bits, and
//              writes positions and payloads to their slots; slots past the
//              total get pos = n and payload 0.  Blocks with no set entry
//              skip the walk.
// Contract (compact2.py:compact_pay / _compact_pay_xla): pos ascending,
// payloads routed by the same permutation, entries past cap dropped.
//
// What bounds it on an H100: device-memory reads of the mask (twice) and of
// the payloads, plus the scattered writes; the arithmetic is a few integer
// ops per entry.  A single-pass scan with decoupled look-back would read the
// mask once; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 16;
constexpr int kChunk = kThreads * kRounds;
constexpr int kScanThreads = 1024;

__global__ void compact_count_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                     int32_t* __restrict__ block_counts) {
  __shared__ int warp_tot[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kChunk;
  int tot = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
    const bool pred = i < n && mask[i] != 0;
    tot += __popc(__ballot_sync(0xffffffffu, pred));
  }
  if (lane == 0) warp_tot[warp] = tot;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_tot[w];
    block_counts[blockIdx.x] = s;
  }
}

__global__ void compact_scan_kernel(const int32_t* __restrict__ block_counts,
                                    int nb, int cap,
                                    int32_t* __restrict__ block_offs,
                                    int32_t* __restrict__ scal) {
  __shared__ int32_t buf[kScanThreads];
  __shared__ int32_t carry;
  const int tid = threadIdx.x;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + tid;
    const int32_t v = i < nb ? block_counts[i] : 0;
    buf[tid] = v;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {
      const int32_t t = tid >= off ? buf[tid - off] : 0;
      __syncthreads();
      buf[tid] += t;
      __syncthreads();
    }
    if (i < nb) block_offs[i] = carry + buf[tid] - v;
    __syncthreads();
    if (tid == kScanThreads - 1) carry += buf[tid];
    __syncthreads();
  }
  if (tid == 0) {
    scal[0] = carry;
    scal[1] = carry <= cap ? 1 : 0;
  }
}

struct Pays {
  const int32_t* in[4];
  int32_t* out[4];
};

__global__ void compact_scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                       const int32_t* __restrict__ block_counts,
                                       const int32_t* __restrict__ block_offs,
                                       Pays pays, int npay, int cap,
                                       const int32_t* __restrict__ scal,
                                       int32_t* __restrict__ pos) {
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int warp_off[kThreads / 32];
  __shared__ int round_tot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  if (block_counts[blockIdx.x] != 0) {
    const int64_t base = (int64_t)blockIdx.x * kChunk;
    int off = block_offs[blockIdx.x];
    for (int r = 0; r < kRounds; ++r) {
      const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
      const bool pred = i < n && mask[i] != 0;
      const unsigned b = __ballot_sync(0xffffffffu, pred);
      if (lane == 0) warp_cnt[warp] = __popc(b);
      __syncthreads();
      if (threadIdx.x == 0) {
        int s = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
          warp_off[w] = s;
          s += warp_cnt[w];
        }
        round_tot = s;
      }
      __syncthreads();
      if (pred) {
        const int dst = off + warp_off[warp] + __popc(b & lower);
        if (dst < cap) {
          pos[dst] = (int32_t)i;
          for (int k = 0; k < npay; ++k) pays.out[k][dst] = pays.in[k][i];
        }
      }
      off += round_tot;
      __syncthreads();
    }
  }
  const int cnt = scal[0];
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * kThreads) {
    if (j >= cnt) {
      pos[j] = (int32_t)n;
      for (int k = 0; k < npay; ++k) pays.out[k][j] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Scratch: block_counts and block_offs hold ceil(n / 4096) int32 each; scal
// holds [count, ok].  n must be in [1, 2^31).
int cgx_compact(const uint8_t* mask, int64_t n, int npay, const int32_t* p0,
                const int32_t* p1, const int32_t* p2, const int32_t* p3,
                int cap, int32_t* pos, int32_t* o0, int32_t* o1, int32_t* o2,
                int32_t* o3, int32_t* block_counts, int32_t* block_offs,
                int32_t* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (int)((n + kChunk - 1) / kChunk);
  Pays pays = {{p0, p1, p2, p3}, {o0, o1, o2, o3}};
  compact_count_kernel<<<nb, kThreads, 0, st>>>(mask, n, block_counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_scan_kernel<<<1, kScanThreads, 0, st>>>(block_counts, nb, cap,
                                                  block_offs, scal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_scatter_kernel<<<nb, kThreads, 0, st>>>(
      mask, n, block_counts, block_offs, pays, npay, cap, scal, pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
