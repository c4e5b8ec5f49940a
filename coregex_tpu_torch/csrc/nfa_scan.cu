// The bitset-NFA scan (cgx_bitset_scan): the unanchored all-ends walk of a
// byte NFA whose DFA overflows, over the corpus's word tiles.
//
// Replaces coregex_tpu/ops/nfa_scan.py:_bitset_scan (:237), a lax.scan with
// an MXU jnp.dot a byte step (:276) and a while_loop of at most 4 repair
// passes (:336); no Pallas kernel.  The TPU multiplies a [L, S] activity
// matrix by the closure table; here one thread walks one sub-lane with its
// live set in registers, as NW = ceil(S/64) <= 8 64-bit words, and ORs the
// closure rows of the set bits that survive the byte.  One step at position
// p, in the boundary context ctx = 4 * class(byte p) + class(byte p + 1)
// (classes: 0 other, 1 word, 2 newline; the next class is 3 at p + 1 = n):
//   m     = a & cover[b]                the range states that take byte b
//   flag  = (m & mbits[g]) != 0         g = gmap[ctx]: a match ends at p+1
//   a'    = startw[smap[ctx]] | OR over s in m of rows[g][s]
// A set reaches at most a few dozen states on text, so a step costs
// popcount(m) row ORs of NW words.
//
// What bounds it on an H100: the row ORs.  Each is NW shared-memory loads
// at a row that depends on the data, after a dependent chain (byte, cover
// load, AND, bit scan); the corpus bytes are read once (0.48 ms at 1536
// MiB).  So the card needs many walkers in flight: the lanes and sub-lanes
// of the lane walks (count_scan.plan_geometry, lane_split: 524,288
// sub-lanes of 3 KiB at 1536 MiB), each warming up over the W bytes before
// it, and the split fixpoint's repair passes, as K1's (lane_scan.cu).  The
// tables sit in shared memory: cover 2 KiB x NW, the closure rows 8 B x G
// x S x NW (at most 128 KiB at S = 512, G = 4).
//
// Layouts:
//   tiles   [T4, L] int32   word t of lane l = bytes l*T + 4t .. + 3
//   flagw   [T4/8, L] int32 bit q%32 of group q/32 = position q of the lane
//                           (K9's layout); sub-lane j owns its T4/(8k)
//                           groups
//   entries, exits, sync [k, L, NW] int64 sets; counts, last [k, L] int32
//                           (set flags of the sub-lane, sub-lane-local
//                           position of its last flag or -1)
//   cover [256, NW], rows [G, S, NW], mbits [G, NW], startw [Gs, NW] int64;
//   gmap, smap [12] int32
// Pass 0 (kFirst): sub-lane (j, l) walks from entries[j, l] over the W4
// words before its first word (j = 0: lane l-1's last W4 words, lane 0's
// skipped by its offset), then its own words up to its limit; sync is the
// set after the warmup, exits after the sub-lane.  Repair passes read prev
// (the previous pass's exits) and write exits.  A sub-lane is unsettled
// when it is real (limit > 0) and its sync differs from the previous
// sub-lane's exit (`first`, the exact text-start set, for sub-lane (0, 0)).
// kSub: each unsettled sub-lane walks again from that exit, no warmup;
// kLane: each lane holding one walks whole from the previous lane's exit.
// The others copy their exit; `walked` counts the walkers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

using cgx::count_walker;
using cgx::sub_limit;

enum Pass { kFirst = 0, kSub = 1, kLane = 2 };

constexpr int kThreads = 128;

struct Tables {
  const uint64_t* cover;
  const uint64_t* rows;
  const uint64_t* mbits;
  const uint64_t* startw;
  const uint8_t* cls;
  const uint8_t* gmap;
  const uint8_t* smap;
  int S;
};

// Word t of lane src of the tiles; t = T4 is the next lane's first word
// (zero after the last lane).
__device__ __forceinline__ uint32_t word_at(const int32_t* __restrict__ tiles,
                                            int T4, int L, int src, int t) {
  if (t < T4) return (uint32_t)tiles[(size_t)t * L + src];
  return src + 1 < L ? (uint32_t)tiles[src + 1] : 0u;
}

template <int NW>
__device__ __forceinline__ bool step(const Tables& tb, uint64_t (&a)[NW],
                                     int c, int ctx) {
  const uint64_t* cov = tb.cover + c * NW;
  const int g = tb.gmap[ctx];
  const uint64_t* rows = tb.rows + (size_t)g * tb.S * NW;
  const uint64_t* mb = tb.mbits + g * NW;
  const uint64_t* sd = tb.startw + tb.smap[ctx] * NW;
  uint64_t m[NW], nx[NW];
  uint64_t hit = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    m[i] = a[i] & cov[i];
    hit |= m[i] & mb[i];
    nx[i] = sd[i];
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t mm = m[i];
    while (mm) {
      const int s = i * 64 + __ffsll((long long)mm) - 1;
      mm &= mm - 1;
      const uint64_t* r = rows + (size_t)s * NW;
#pragma unroll
      for (int w = 0; w < NW; ++w) nx[w] |= r[w];
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) a[i] = nx[i];
  return hit != 0;
}

// Walks words t0 .. t0 + nw - 1 of lane src from set a, stepping the
// walk-local positions q (byte q of the walk, global position p0 + q) with
// skip <= q < lim.  With flagw, writes the flag word of each group of 8
// words (at group t0/8 + g of lane src) and sums its flags into cnt and its
// last flag's position into last.
template <int NW>
__device__ __forceinline__ void walk(const Tables& tb,
                                     const int32_t* __restrict__ tiles,
                                     int T4, int L, int src, int t0, int nw,
                                     long long p0, long long n, int lim,
                                     int skip, uint64_t (&a)[NW],
                                     int32_t* __restrict__ flagw, int& cnt,
                                     int& last) {
  uint32_t cur = lim > 0 ? word_at(tiles, T4, L, src, t0) : 0u;
  uint32_t fw = 0;
#pragma unroll 1
  for (int t = 0; t < nw; ++t) {
    if (4 * t < lim) {
      const uint32_t nx = word_at(tiles, T4, L, src, t0 + t + 1);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int q = 4 * t + b;
        if (q < lim && q >= skip) {
          const int c = (cur >> (8 * b)) & 255;
          const int d = b < 3 ? (cur >> (8 * b + 8)) & 255 : nx & 255;
          const int nc = p0 + q + 1 == n ? 3 : tb.cls[d];
          if (step<NW>(tb, a, c, tb.cls[c] * 4 + nc)) fw |= 1u << (q & 31);
        }
      }
      cur = nx;
    }
    if (flagw != nullptr && (t & 7) == 7) {
      flagw[(size_t)(t0 / 8 + t / 8) * L + src] = (int32_t)fw;
      if (fw != 0) {
        cnt += __popc(fw);
        last = (t / 8) * 32 + 31 - __clz((int)fw);
      }
      fw = 0;
    }
  }
}

template <int NW>
__device__ __forceinline__ void load_set(uint64_t (&a)[NW],
                                         const int64_t* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < NW; ++i) a[i] = (uint64_t)src[i];
}

template <int NW>
__device__ __forceinline__ void store_set(int64_t* __restrict__ dst,
                                          const uint64_t (&a)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) dst[i] = (int64_t)a[i];
}

template <int NW>
__device__ __forceinline__ bool same_set(const int64_t* __restrict__ x,
                                         const int64_t* __restrict__ y) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < NW; ++i) eq &= x[i] == y[i];
  return eq;
}

template <int NW, int PASS>
__global__ void __launch_bounds__(kThreads) bitset_kernel(
    const int64_t* __restrict__ cover, const int64_t* __restrict__ rows,
    const int64_t* __restrict__ mbits, const int64_t* __restrict__ startw,
    const int32_t* __restrict__ gmap, const int32_t* __restrict__ smap,
    int S, int G, int Gs, const int32_t* __restrict__ tiles, int T4, int L,
    int W4, int k, int n, const int64_t* __restrict__ entries,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ limits,
    const int64_t* __restrict__ first, const int64_t* __restrict__ prev,
    int32_t* __restrict__ counts, int32_t* __restrict__ last,
    int64_t* __restrict__ exits, int64_t* __restrict__ sync,
    int32_t* __restrict__ flagw, int32_t* __restrict__ walked) {
  extern __shared__ uint64_t smem[];
  const int n_cover = 256 * NW, n_rows = G * S * NW, n_mb = G * NW,
            n_st = Gs * NW;
  uint64_t* s_cover = smem;
  uint64_t* s_rows = s_cover + n_cover;
  uint64_t* s_mb = s_rows + n_rows;
  uint64_t* s_st = s_mb + n_mb;
  uint8_t* s_cls = (uint8_t*)(s_st + n_st);
  uint8_t* s_gmap = s_cls + 256;
  uint8_t* s_smap = s_gmap + 12;
  for (int i = threadIdx.x; i < n_cover; i += blockDim.x)
    s_cover[i] = (uint64_t)cover[i];
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x)
    s_rows[i] = (uint64_t)rows[i];
  for (int i = threadIdx.x; i < n_mb; i += blockDim.x)
    s_mb[i] = (uint64_t)mbits[i];
  for (int i = threadIdx.x; i < n_st; i += blockDim.x)
    s_st[i] = (uint64_t)startw[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const bool word = (i >= 48 && i <= 57) || (i >= 65 && i <= 90) ||
                      i == 95 || (i >= 97 && i <= 122);
    s_cls[i] = word ? 1 : (i == 10 ? 2 : 0);
  }
  if (threadIdx.x < 12) {
    s_gmap[threadIdx.x] = (uint8_t)gmap[threadIdx.x];
    s_smap[threadIdx.x] = (uint8_t)smap[threadIdx.x];
  }
  __syncthreads();
  const Tables tb{s_cover, s_rows, s_mb, s_st, s_cls, s_gmap, s_smap, S};

  const int G8 = T4 / 8 / k;   // flag groups of a sub-lane
  const int Tk = G8 * 32;      // bytes of a sub-lane
  const long long T = 4LL * T4;
  uint64_t a[NW];

  if (PASS == kLane) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int lim = limits[l];
    const int64_t* enter =
        l > 0 ? prev + ((size_t)(k - 1) * L + l - 1) * NW : first;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      const int64_t* want = j > 0 ? prev + ((size_t)(j - 1) * L + l) * NW
                                  : enter;
      bad |= sub_limit(lim, j, Tk) > 0 &&
             !same_set<NW>(sync + ((size_t)j * L + l) * NW, want);
    }
    if (!bad) {
      for (int j = 0; j < k; ++j) {
        const size_t i = (size_t)j * L + l;
        load_set<NW>(a, prev + i * NW);
        store_set<NW>(exits + i * NW, a);
      }
      return;
    }
    count_walker(walked);
    load_set<NW>(a, enter);
    for (int j = 0; j < k; ++j) {
      const size_t i = (size_t)j * L + l;
      int cnt = 0, lst = -1;
      store_set<NW>(sync + i * NW, a);
      walk<NW>(tb, tiles, T4, L, l, j * G8 * 8, G8 * 8,
               l * T + (long long)j * Tk, n, sub_limit(lim, j, Tk), 0, a,
               flagw, cnt, lst);
      counts[i] = cnt;
      last[i] = lst;
      store_set<NW>(exits + i * NW, a);
    }
    return;
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * L) return;
  const int j = i / L, l = i - j * L;
  const int lim = sub_limit(limits[l], j, Tk);
  if (PASS == kSub) {
    const int64_t* want =
        j > 0 ? prev + (size_t)(i - L) * NW
              : (l > 0 ? prev + ((size_t)(k - 1) * L + l - 1) * NW : first);
    if (lim == 0 || same_set<NW>(sync + (size_t)i * NW, want)) {
      load_set<NW>(a, prev + (size_t)i * NW);
      store_set<NW>(exits + (size_t)i * NW, a);
      return;
    }
    count_walker(walked);
    load_set<NW>(a, want);
  } else {
    // warmup over the W4 words before the sub-lane's first word
    load_set<NW>(a, entries + (size_t)i * NW);
    const int off = j == 0 ? offsets[l] : 0;
    if (off < 4 * W4) {
      const int src = j == 0 ? (l == 0 ? L - 1 : l - 1) : l;
      const int w0 = (j == 0 ? T4 : j * G8 * 8) - W4;
      int cnt = 0, lst = -1;
      walk<NW>(tb, tiles, T4, L, src, w0, W4, src * T + 4LL * w0, n, 4 * W4,
               off, a, nullptr, cnt, lst);
    }
  }
  store_set<NW>(sync + (size_t)i * NW, a);
  int cnt = 0, lst = -1;
  walk<NW>(tb, tiles, T4, L, l, j * G8 * 8, G8 * 8, l * T + (long long)j * Tk,
           n, lim, 0, a, flagw, cnt, lst);
  counts[i] = cnt;
  last[i] = lst;
  store_set<NW>(exits + (size_t)i * NW, a);
}

size_t smem_bytes(int S, int NW, int G, int Gs) {
  return (size_t)8 * NW * (256 + (size_t)G * S + G + Gs) + 256 + 24;
}

template <int NW, int PASS>
int launch(const int64_t* cover, const int64_t* rows, const int64_t* mbits,
           const int64_t* startw, const int32_t* gmap, const int32_t* smap,
           int S, int G, int Gs, const int32_t* tiles, int T4, int L, int W4,
           int k, int n, const int64_t* entries, const int32_t* offsets,
           const int32_t* limits, const int64_t* first, const int64_t* prev,
           int32_t* counts, int32_t* last, int64_t* exits, int64_t* sync,
           int32_t* flagw, int32_t* walked, void* stream) {
  const size_t smem = smem_bytes(S, NW, G, Gs);
  auto kernel = bitset_kernel<NW, PASS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (PASS != kFirst) {
    e = cudaMemsetAsync(walked, 0, sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  const long long walkers = PASS == kLane ? L : (long long)k * L;
  const int blocks = (int)((walkers + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, st>>>(
      cover, rows, mbits, startw, gmap, smap, S, G, Gs, tiles, T4, L, W4, k,
      n, entries, offsets, limits, first, prev, counts, last, exits, sync,
      flagw, walked);
  return (int)cudaGetLastError();
}

template <int NW>
int launch_pass(int pass, const int64_t* cover, const int64_t* rows,
                const int64_t* mbits, const int64_t* startw,
                const int32_t* gmap, const int32_t* smap, int S, int G,
                int Gs, const int32_t* tiles, int T4, int L, int W4, int k,
                int n, const int64_t* entries, const int32_t* offsets,
                const int32_t* limits, const int64_t* first,
                const int64_t* prev, int32_t* counts, int32_t* last,
                int64_t* exits, int64_t* sync, int32_t* flagw,
                int32_t* walked, void* stream) {
#define CGX_LAUNCH(P)                                                        \
  return launch<NW, P>(cover, rows, mbits, startw, gmap, smap, S, G, Gs,     \
                       tiles, T4, L, W4, k, n, entries, offsets, limits,     \
                       first, prev, counts, last, exits, sync, flagw, walked, \
                       stream)
  if (pass == kFirst) CGX_LAUNCH(kFirst);
  if (pass == kSub) CGX_LAUNCH(kSub);
  CGX_LAUNCH(kLane);
#undef CGX_LAUNCH
}

}  // namespace

extern "C" {

// Pass 0 (kFirst, with warmup) or a repair pass (kSub, kLane) of the
// bitset-NFA scan over k sub-lanes a lane, sets of NW = 1..8 words.
// Repair passes read prev and first and write exits, and zero then count
// *walked; pass 0 reads entries and offsets.
int cgx_bitset_scan(int pass, const int64_t* cover, const int64_t* rows,
                    const int64_t* mbits, const int64_t* startw,
                    const int32_t* gmap, const int32_t* smap, int S, int NW,
                    int G, int Gs, const int32_t* tiles, int T4, int L,
                    int W4, int k, int n, const int64_t* entries,
                    const int32_t* offsets, const int32_t* limits,
                    const int64_t* first, const int64_t* prev,
                    int32_t* counts, int32_t* last, int64_t* exits,
                    int64_t* sync, int32_t* flagw, int32_t* walked,
                    void* stream) {
#define CGX_NW(W)                                                            \
  case W:                                                                    \
    return launch_pass<W>(pass, cover, rows, mbits, startw, gmap, smap, S, G, \
                          Gs, tiles, T4, L, W4, k, n, entries, offsets,      \
                          limits, first, prev, counts, last, exits, sync,    \
                          flagw, walked, stream)
  switch (NW) {
    CGX_NW(1);
    CGX_NW(2);
    CGX_NW(3);
    CGX_NW(4);
    CGX_NW(5);
    CGX_NW(6);
    CGX_NW(7);
    CGX_NW(8);
  }
#undef CGX_NW
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of kThreads threads per SM of a pass-0 launch on tables
// of S states, NW words, G closure and Gs start groups.
int cgx_bitset_occupancy(int S, int NW, int G, int Gs, int* blocks) {
  const size_t smem = smem_bytes(S, NW, G, Gs);
#define CGX_OCC(W)                                                           \
  case W: {                                                                  \
    auto kernel = bitset_kernel<W, kFirst>;                                  \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
    if (e != cudaSuccess) return (int)e;                                     \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks, kernel, kThreads, smem);                                     \
  }
  switch (NW) {
    CGX_OCC(1);
    CGX_OCC(2);
    CGX_OCC(3);
    CGX_OCC(4);
    CGX_OCC(5);
    CGX_OCC(6);
    CGX_OCC(7);
    CGX_OCC(8);
  }
#undef CGX_OCC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
