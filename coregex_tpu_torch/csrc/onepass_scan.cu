// The OnePass capture walk (cgx_onepass_extract): the capture slots of many
// verified match spans at once, one span a thread.
//
// Replaces coregex_tpu/ops/onepass_scan.py:_onepass_window (:84), a
// lax.scan over the columns of a [B, W] window whose byte step gathers the
// state's table row with a float32 one-hot matmul (the slot masks split at
// bit 16 so that they round-trip it); no Pallas kernel.  The reference
// launches once per power-of-two width bucket; here one launch walks every
// span to its own end.  One step at position p < end of a span, in state s:
//   c = classes[byte p]; (nxt, mask) = trans[s, c]
//   nxt < 0: the lane dies (ok = 0, its slots stay as they are)
//   slot i = p for every bit i of mask; s = nxt
// and at p == end: ok = match_cond[s], and when it holds, slot i = end for
// every bit i of match_slots[s] (the reference's body, :96-131).  A span
// wider than kMaxWindow is not walked: slots -1, ok 0, as the reference
// leaves the spans past its largest bucket.
//
// What bounds it on an H100: the dependent chain of a step (byte load,
// class load, table load) times the longest span of a warp; the bytes
// (spans 8 B, the span's bytes, NS slots of 4 B and ok) are few.  So the
// card wants many spans in flight: one thread each, 128 a block.  The
// slots live in shared memory, slot-major (slot i of thread t at
// i * kThreads + t, no bank conflict), since a mask names its slots by
// bit number and registers cannot be indexed; a mask is 0 on most bytes.
// The tables go to shared memory when they fit beside the slots; a OnePass
// DFA may have up to 4096 states (dfa/onepass.py's cap), so a larger one is
// read from global memory (through the read-only cache) by the same kernel,
// never declined.
//
// Layouts:
//   trans  [S, C] int2   {next state (-1: none), slot mask}
//   fin    [S] int2      {match_cond, match_slots}
//   classes [256] int32
//   spans  [M, 2] int32  start, end; positions are int32 (the corpus is at
//                        most MAX_CORPUS bytes); a walked span reads bytes
//                        start .. end - 1, clamped to the corpus
//   slots  [M, NS] int32 (-1: unset); ok [M] bool

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWindow = 1 << 14;
constexpr int kMaxSlots = 32;

size_t smem_bytes(int S, int C, int NS, bool shared_tables) {
  size_t b = (size_t)4 * (NS * kThreads + 256);
  if (shared_tables) b += (size_t)8 * ((size_t)S * C + S);
  return b;
}

__device__ __forceinline__ void set_slots(int32_t* sl, uint32_t mask,
                                          int p) {
  while (mask) {
    const int i = __ffs(mask) - 1;
    mask &= mask - 1;
    sl[i * kThreads] = p;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    onepass_kernel(const int2* __restrict__ trans, const int2* __restrict__ fin,
                   const int32_t* __restrict__ classes, int S, int C, int NS,
                   int start, const uint8_t* __restrict__ data, int n,
                   const int32_t* __restrict__ spans, int M,
                   int32_t* __restrict__ slots, bool* __restrict__ ok) {
  extern __shared__ int4 smem[];
  int32_t* sl = reinterpret_cast<int32_t*>(smem);   // [NS][kThreads]
  int32_t* cls = sl + NS * kThreads;                 // [256]
  int2* tr_s = reinterpret_cast<int2*>(cls + 256);   // [S * C], then [S]
  for (int i = threadIdx.x; i < 256; i += kThreads) cls[i] = classes[i];
  const int2* tr = trans;
  const int2* fn = fin;
  if (kShared) {
    const int nt = S * C;
    for (int i = threadIdx.x; i < nt; i += kThreads) tr_s[i] = trans[i];
    for (int i = threadIdx.x; i < S; i += kThreads) tr_s[nt + i] = fin[i];
    tr = tr_s;
    fn = tr_s + nt;
  }
  __syncthreads();
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  int32_t* mine = sl + threadIdx.x;
  for (int i = 0; i < NS; ++i) mine[i * kThreads] = -1;
  const uint32_t keep = NS >= kMaxSlots ? ~0u : (1u << NS) - 1u;
  const int a = spans[2 * m], e = spans[2 * m + 1];
  bool good = false;
  if ((long long)e - a <= kMaxWindow) {
    int s = start;
    int p = a;
    bool dead = false;
#pragma unroll 1
    for (; p < e; ++p) {
      const int q = p < 0 ? 0 : (p >= n ? n - 1 : p);
      const int2 t = tr[s * C + cls[n > 0 ? data[q] : 0]];
      if (t.x < 0) {
        dead = true;
        break;
      }
      set_slots(mine, (uint32_t)t.y & keep, p);
      s = t.x;
    }
    if (!dead && p == e) {
      const int2 f = fn[s];
      good = f.x != 0;
      if (good) set_slots(mine, (uint32_t)f.y & keep, p);
    }
  }
  int32_t* out = slots + m * NS;
  for (int i = 0; i < NS; ++i) out[i] = mine[i * kThreads];
  ok[m] = good;
}

template <bool kShared>
int launch(const int2* trans, const int2* fin, const int32_t* classes, int S,
           int C, int NS, int start, const uint8_t* data, int n,
           const int32_t* spans, int M, int32_t* slots, bool* ok,
           void* stream) {
  const size_t smem = smem_bytes(S, C, NS, kShared);
  auto kernel = onepass_kernel<kShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(((long long)M + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      trans, fin, classes, S, C, NS, start, data, n, spans, M, slots, ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Capture slots of M spans [M, 2] over the corpus data[n] under a OnePass
// DFA of S states and C classes with NS <= 32 slots; shared = 1 holds the
// tables in shared memory (the caller checks that smem_bytes fits a block),
// 0 reads them from global memory.
int cgx_onepass_extract(const int32_t* trans, const int32_t* fin,
                        const int32_t* classes, int S, int C, int NS,
                        int start, int shared, const uint8_t* data, int n,
                        const int32_t* spans, int M, int32_t* slots, bool* ok,
                        void* stream) {
  if (NS < 1 || NS > kMaxSlots || S < 1 || C < 1 || M < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int2* tr = reinterpret_cast<const int2*>(trans);
  const int2* fn = reinterpret_cast<const int2*>(fin);
  if (shared)
    return launch<true>(tr, fn, classes, S, C, NS, start, data, n, spans, M,
                        slots, ok, stream);
  return launch<false>(tr, fn, classes, S, C, NS, start, data, n, spans, M,
                       slots, ok, stream);
}

}  // extern "C"
