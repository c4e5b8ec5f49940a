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
// wider than kMaxWindow, or ending before its start, is not walked: slots
// -1, ok 0, as the reference leaves the spans past its largest bucket.
//
// What bounds it on an H100: memory traffic, not the walk.  The spans of a
// find_all are short (ip's are 7-15 bytes) and far apart (about 600 bytes),
// and the tables are tiny, so the bytes to move are the spans (8 B), the
// span's bytes, and NS slots of 4 B and ok a span; the slots are most of
// them.  The design moves them in few, wide transactions:
//   * a span's bytes come in aligned 16-byte chunks (ld.global.nc), the
//     next chunk requested before the current one is walked; the chunks
//     are shifted so that byte k of a 16-byte window is span byte k, and
//     the window is walked with constant byte offsets (an 11-byte span
//     costs one or two loads, not 11);
//   * the slots are written into a row-major shared slab [kThreads][NS | 1]
//     (the odd row stride keeps a warp's 32 rows on 32 banks), then, after
//     a barrier, the block writes its contiguous [rows, NS] slab of the
//     output with neighbouring threads on neighbouring words;
//   * the tables sit in shared memory where they fit beside the slab, else
//     they are read from global memory (a OnePass DFA may have up to 4096
//     states, dfa/onepass.py's cap): the kernel never declines.  A
//     byte-indexed table (one lookup a step, no class lookup) measured
//     within 1 % of the class-indexed one on the bench's spans, whose walks
//     are short: the time is in the memory traffic;
//   * blocks are persistent (as many as stay resident) and walk tiles of
//     kThreads spans, so each copies its tables once.
//
// Layouts:
//   trans   [S, C] int2    {next state (-1: none), slot mask}
//   fin     [S] int2       {match_cond, match_slots}
//   classes [256] int32
//   spans   [M, 2] int32   start, end (8-byte aligned rows); positions are
//                          int32 (the corpus is at most MAX_CORPUS bytes);
//                          a span inside the corpus reads bytes start ..
//                          end - 1, one outside it reads each byte clamped
//                          to the corpus (byte 0 of an empty corpus reads
//                          as 0)
//   slots   [M, NS] int32 (-1: unset); ok [M] bool

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 1 << 14;
constexpr int kMaxSlots = 32;

// The slot slab [kThreads][NS | 1], then fin and trans when they sit in
// shared memory, then the classes.
size_t smem_bytes(int S, int C, int NS, bool shared_tables) {
  size_t b = (size_t)4 * kThreads * (NS | 1) + 4 * 256;
  if (shared_tables) b += (size_t)8 * S + 8 * (size_t)S * C;
  return b;
}

struct Args {
  const int2* trans;
  const int2* fin;
  const int32_t* classes;
  int S, C, NS, start;
  const uint8_t* data;
  int n;
  const int2* spans;
  long long M;
  int32_t* slots;
  bool* ok;
};

// The tables, in shared or global memory; a step gives the next state (-1:
// dead) and the slot mask.
struct Tab {
  const int2* tr;
  const int32_t* cls;
  const int2* fin;
  int C;
  __device__ __forceinline__ int step(int s, int byte, uint32_t& mask) const {
    const int2 t = tr[s * C + cls[byte]];
    mask = (uint32_t)t.y;
    return t.x;
  }
};

__device__ __forceinline__ void set_slots(int32_t* row, uint32_t mask,
                                          int p) {
  while (mask) {
    row[__ffs(mask) - 1] = p;
    mask &= mask - 1;
  }
}

// Bytes r .. r + 15 of the 32 bytes cur ++ nxt, as four words.
__device__ __forceinline__ void window(const uint4& cur, const uint4& nxt,
                                       int r, uint32_t w[4]) {
  const uint32_t v[8] = {cur.x, cur.y, cur.z, cur.w,
                         nxt.x, nxt.y, nxt.z, nxt.w};
  const int q = r >> 2;
  uint32_t u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    u[i] = q == 0 ? v[i] : q == 1 ? v[i + 1] : q == 2 ? v[i + 2] : v[i + 3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = __funnelshift_r(u[i], u[i + 1], 8 * (r & 3));
}

// Walks span [sa, se) into the thread's slot row; returns ok.
__device__ __forceinline__ bool walk(const Tab& tb, const Args& a, int sa,
                                     int se, int32_t* row, uint32_t keep) {
  if (se < sa || (long long)se - sa > kMaxWindow) return false;
  int s = a.start;
  if (se > sa && sa >= 0 && se <= a.n) {
    // aligned chunks; a chunk is loaded only when it holds a span byte
    const uint8_t* p0 = a.data + sa;
    const int r = (int)(reinterpret_cast<uintptr_t>(p0) & 15);
    const uint4* q = reinterpret_cast<const uint4*>(p0 - r);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    int left = se - sa, pos = sa;
    uint4 cur = __ldg(q);
    uint4 nxt = r + left > 16 ? __ldg(q + 1) : zero;
#pragma unroll 1
    for (;;) {
      const uint4 ahead = r + left > 32 ? __ldg(q + 2) : zero;
      uint32_t w[4];
      window(cur, nxt, r, w);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k >= left) break;
        uint32_t mask;
        const int nx = tb.step(s, (w[k >> 2] >> (8 * (k & 3))) & 255, mask);
        if (nx < 0) return false;
        if (mask & keep) set_slots(row, mask & keep, pos + k);
        s = nx;
      }
      if (left <= 16) break;
      left -= 16;
      pos += 16;
      ++q;
      cur = nxt;
      nxt = ahead;
    }
  } else {
    // a span reaching outside the corpus: each byte clamped to it
#pragma unroll 1
    for (int p = sa; p < se; ++p) {
      const int c = p < 0 ? 0 : (p >= a.n ? a.n - 1 : p);
      uint32_t mask;
      const int nx = tb.step(s, a.n > 0 ? a.data[c] : 0, mask);
      if (nx < 0) return false;
      if (mask & keep) set_slots(row, mask & keep, p);
      s = nx;
    }
  }
  const int2 f = tb.fin[s];
  if (f.x == 0) return false;
  set_slots(row, (uint32_t)f.y & keep, se);
  return true;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) onepass_kernel(Args a) {
  extern __shared__ int4 smem[];
  const int NS = a.NS, NSP = NS | 1;
  int32_t* slab = reinterpret_cast<int32_t*>(smem);   // [kThreads][NSP]
  int2* fin_s = reinterpret_cast<int2*>(slab + kThreads * NSP);
  int2* tr_s = fin_s + a.S;
  int32_t* cls = kShared ? reinterpret_cast<int32_t*>(tr_s + a.S * a.C)
                         : reinterpret_cast<int32_t*>(fin_s);
  for (int i = threadIdx.x; i < 256; i += kThreads) cls[i] = a.classes[i];
  Tab tb{a.trans, cls, a.fin, a.C};
  if (kShared) {
    for (int i = threadIdx.x; i < a.S; i += kThreads) fin_s[i] = a.fin[i];
    for (int i = threadIdx.x; i < a.S * a.C; i += kThreads)
      tr_s[i] = a.trans[i];
    tb.tr = tr_s;
    tb.fin = fin_s;
  }
  __syncthreads();
  const uint32_t keep = NS >= kMaxSlots ? ~0u : (1u << NS) - 1u;
  int32_t* row = slab + threadIdx.x * NSP;
  // the block's store: flat entry f = r * NS + i of its [rows, NS] slab
  const int r0 = threadIdx.x / NS, i0 = threadIdx.x % NS;
  const int dr = kThreads / NS, di = kThreads % NS;
  const long long tiles = (a.M + kThreads - 1) / kThreads;
#pragma unroll 1
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile * kThreads, m = m0 + threadIdx.x;
    for (int i = 0; i < NS; ++i) row[i] = -1;
    if (m < a.M) {
      const int2 sp = a.spans[m];
      a.ok[m] = walk(tb, a, sp.x, sp.y, row, keep);
    }
    __syncthreads();
    const int rows = (int)(a.M - m0 < kThreads ? a.M - m0 : kThreads);
    int32_t* out = a.slots + m0 * NS;
    int r = r0, i = i0;
    for (int f = threadIdx.x; f < rows * NS; f += kThreads) {
      out[f] = slab[r * NSP + i];
      r += dr;
      i += di;
      if (i >= NS) {
        i -= NS;
        ++r;
      }
    }
    __syncthreads();
  }
}

template <bool kShared>
int launch(const Args& a, void* stream) {
  const int smem = (int)smem_bytes(a.S, a.C, a.NS, kShared);
  auto kernel = onepass_kernel<kShared>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (a.M + kThreads - 1) / kThreads;
  const int blocks = (int)(tiles < (long long)sms * per_sm
                               ? tiles : (long long)sms * per_sm);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Capture slots of M spans [M, 2] over the corpus data[n] under a OnePass
// DFA of S states and C classes with NS <= 32 slots; shared = 1 holds the
// tables in shared memory (the caller checks that smem_bytes fits a
// block), 0 reads them from global memory.  The spans' rows are 8-byte
// aligned.
int cgx_onepass_extract(const int32_t* trans, const int32_t* fin,
                        const int32_t* classes, int S, int C, int NS,
                        int start, int shared, const uint8_t* data, int n,
                        const int32_t* spans, int M, int32_t* slots, bool* ok,
                        void* stream) {
  if (NS < 1 || NS > kMaxSlots || S < 1 || C < 1 || M < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Args a = {reinterpret_cast<const int2*>(trans),
                  reinterpret_cast<const int2*>(fin), classes, S, C, NS,
                  start, data, n, reinterpret_cast<const int2*>(spans), M,
                  slots, ok};
  if (shared) return launch<true>(a, stream);
  return launch<false>(a, stream);
}

}  // extern "C"
