// Window-flag scan: B anchored DFA runs, each walking at most W bytes from
// its own start offset, with the per-position match flags as a bitmap.
//
// Ports the JAX package's _window_scan_flags (ops/dfa_scan.py:626-674), a
// lax.scan loop with no Pallas kernel: find_first's reverse start search
// (meta/batch.py:_rev_start_flags) runs it over the anchored reverse DFA
// from the found match end.  The packed value is delta*32 + match.
//
// Semantics per lane b (positions in the scanned coordinates; with
// `reverse` the scan reads the corpus backwards, scanned position j being
// corpus byte n-1-j, so reverse scans need no flipped copy of the corpus):
//   start state = starts_tbl[context of the byte before start], SOT at 0
//   cut = min(edge[b], n), its context = SOT at n, else that of byte cut
//   column t < W: the match flag of step t while start+t < cut; at
//                 start+t == cut the EOI flag eoi[state, cut context]
//   column W: the EOI flag when start+W == cut; alive = live and start+W < cut
// A lane stops at DEAD (absorbing, no flags), so the rest of its row is 0:
// the wrapper allocates the bitmap zeroed.
//
// Layouts: flagw [NW, B] int32, NW = ceil((W+1)/32), bit t%32 of word t/32
// = column t of the lane (lane-minor, so a warp's word stores coalesce);
// alive [B] int32; eoi [S, 4] int32; starts_tbl [4] int32.
//
// What bounds it on an H100: each lane is one dependent chain of
// shared-memory table lookups, one per byte, with byte loads scattered over
// the corpus.  find_first launches it with one live lane (B = 16), so a
// call costs its lane's walk length times one lookup's latency; the card is
// otherwise idle.  Widening one lane's walk is not possible (the chain is
// sequential); the design keeps the walk short instead (W = 64, x4 while the
// lane lives).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSot = 0, kWord = 1, kNl = 2, kOther = 3;
constexpr int kDead = 0;

__device__ __forceinline__ int context_of(int b) {
  const bool word = (b >= '0' && b <= '9') || (b >= 'A' && b <= 'Z') ||
                    b == '_' || (b >= 'a' && b <= 'z');
  return word ? kWord : (b == '\n' ? kNl : kOther);
}

__global__ void window_flags_kernel(
    const int32_t* __restrict__ packed, int nseg, int ntbl,
    const int32_t* __restrict__ segmap, const int32_t* __restrict__ eoi,
    const int32_t* __restrict__ starts_tbl, const uint8_t* __restrict__ data,
    long long n, int reverse, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ edge, int B, int W,
    int32_t* __restrict__ flagw, int32_t* __restrict__ alive) {
  extern __shared__ int32_t smem[];
  int32_t* tbl = smem;
  int32_t* seg = smem + ntbl;
  for (int i = threadIdx.x; i < ntbl; i += blockDim.x) tbl[i] = packed[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) seg[i] = segmap[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // clamped like the reference's gathers (callers pass 0 <= start <= n)
  auto byte_at = [&](long long j) -> int {
    j = j < 0 ? 0 : (j >= n ? n - 1 : j);
    return data[reverse ? n - 1 - j : j];
  };
  const long long st0 = starts[b];
  int s = starts_tbl[st0 == 0 ? kSot : context_of(byte_at(st0 - 1))];
  const long long cut = min((long long)edge[b], n);
  const int cut_ctx = cut >= n ? kSot : context_of(byte_at(cut));

  uint32_t fw = 0;
  for (int t = 0; t < W; ++t) {
    const long long pos = st0 + t;
    int flag = 0;
    if (pos < cut) {
      const int v = tbl[s * nseg + seg[byte_at(pos)]];
      flag = v & 1;
      s = v >> 5;
    } else {
      if (pos == cut && s != kDead) flag = eoi[s * 4 + cut_ctx];
      s = kDead;
    }
    fw |= (uint32_t)flag << (t & 31);
    if (s == kDead) {
      flagw[(size_t)(t >> 5) * B + b] = (int32_t)fw;
      alive[b] = 0;
      return;
    }
    if ((t & 31) == 31) {
      flagw[(size_t)(t >> 5) * B + b] = (int32_t)fw;
      fw = 0;
    }
  }
  // every step was inside the window and the lane is live
  const long long end_pos = st0 + W;
  if (end_pos == cut) fw |= (uint32_t)eoi[s * 4 + cut_ctx] << (W & 31);
  flagw[(size_t)(W >> 5) * B + b] = (int32_t)fw;
  alive[b] = end_pos < cut ? 1 : 0;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" {

int cgx_window_flags(const int32_t* packed, int S, int nseg,
                     const int32_t* segmap, const int32_t* eoi,
                     const int32_t* starts_tbl, const uint8_t* data,
                     long long n, int reverse, const int32_t* starts,
                     const int32_t* edge, int B, int W, int32_t* flagw,
                     int32_t* alive, void* stream) {
  const int ntbl = S * nseg;
  const size_t smem = (size_t)(ntbl + 256) * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      window_flags_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kThreads - 1) / kThreads;
  window_flags_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      packed, nseg, ntbl, segmap, eoi, starts_tbl, data, n, reverse, starts,
      edge, B, W, flagw, alive);
  return (int)cudaGetLastError();
}

}  // extern "C"
