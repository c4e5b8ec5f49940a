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
// popcount(m) row ORs.
//
// What bounds it on an H100: the table loads and instructions of a byte's
// step, not the corpus (read once: 0.48 ms at 1536 MiB).  The walkers of a
// warp sit on 32 lanes of unrelated text, so the warp steps every byte for
// whichever of them is busy: on the bench corpus 99.8 % of a warp's bytes
// hold a walker whose set is not its seed, though 81 % of each walker's
// bytes are idle (tools/bitset_busy_model.py).  A branch that skipped
// idle walkers' bytes cost 2-15 % more than stepping them, so the step is
// cut, not skipped (numbers: PERF.md, PR 15, NVIDIA H100 80GB HBM3, 700 W):
// * The ASCII word (pass-0 kernels specialised on `ascii`).  nfa_scan.py
//   packs the states sorted by byte range, so the states that take some
//   byte < 128 come first; when at most 64 do (UTF-8 splits [^u-z] into 29
//   such states and hundreds of others), a byte < 128 can only take states
//   of word 0.  Its step reads word 0 of cover, mbits and startw, ORs word
//   0 of the closure rows a byte of m at a time (a table of 256 ORs for
//   each of m's 8 bytes: states of one range sit side by side, so on the
//   bench corpus a warp loops twice a byte for the forward
//   [a-q][^u-z]{13}x, where one row a state took 10 times), and leaves
//   words 1.. of the set stale (`lazy`): they are startw[sl] | OR over s
//   in ml of rows[gl][s] for the last such step's m, closure and start
//   group, brought back before a byte >= 128 or a store.
// * At NW <= 2 the rows are ORed a nibble of m at a time, whichever word
//   holds it (a table of 16 ORs a nibble).  Above, and on bytes >= 128,
//   one row a state of m, once a word.
// * Shapes specialised at compile time (Mode).  Without looks (G = Gs = 1,
//   gmap and smap all 0) the walk computes no context: no byte classes, no
//   end-of-text test, mbits and startw in registers.  With looks the byte
//   classes come from a 256-byte table and gmap and smap from a register,
//   2 bits a context.
// * No branch but the row ORs: a warp's walkers diverge on nothing else.
// * The corpus: 8 words in flight a walker, whole words stepped with no
//   bounds tests (only a walk's first and last words test skip and lim).
// * Blocks of 256 walkers (adjacent threads on adjacent lanes, so the
//   [T4, L] tile reads stay coalesced), each copying the tables and
//   building the chunk tables in shared memory once; registers capped by
//   NW so that 24-32 warps fit an SM.  A persistent grid of resident
//   blocks, each walking walker after walker, took 1-10 % longer.
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
// The others copy their exit; `walked` counts the walkers.  Only pass 0
// has the ASCII specialisation: repair passes walk few sub-lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

using cgx::count_walker;
using cgx::sub_limit;

enum Pass { kFirst = 0, kSub = 1, kLane = 2 };
// The tables' shapes the kernel is specialised on (nfa_scan.py's MODE_*):
// no looks (G = Gs = 1: no byte context, mbits and startw in registers);
// looks (mbits and startw in shared memory: selecting a group's words in
// registers took 4-6 % longer at NW = 2).
enum Mode { kFree = 0, kLook = 1 };

constexpr int kThreads = 256;
constexpr int kAhead = 8;   // words a walker loads ahead of the one it steps

// 64-bit words of the chunk tables: 8 bytes x 256 values of word 0 a
// closure group (ASCII kernels), or NW words x 16 nibbles x 16 values x
// NW a group (NW <= 2); none above.
__host__ __device__ constexpr int chunk_words(int NW, int G, bool ascii) {
  return ascii && NW > 1 ? G * 8 * 256 : NW <= 2 ? G * NW * 256 * NW : 0;
}

// Shared memory of a block: the tables, the chunk tables, byte classes.
inline size_t smem_bytes(int S, int NW, int G, int Gs, bool ascii) {
  return (size_t)8 * (NW * (256 + (size_t)G * S + G + Gs) +
                      chunk_words(NW, G, ascii)) + 256;
}

// Word t of lane src of the tiles; t = T4 is the next lane's first word
// (zero after the last lane; any t > T4 reads that word too).
__device__ __forceinline__ uint32_t word_at(const int32_t* __restrict__ tiles,
                                            int T4, int L, int src, int t) {
  if (t < T4) return (uint32_t)tiles[(size_t)t * L + src];
  return src + 1 < L ? (uint32_t)tiles[src + 1] : 0u;
}

// One walker's set, and the tables, in shared memory or registers by Mode.
template <int NW_, int MODE_, bool ASCII_>
struct Walker {
  static constexpr int NW = NW_, MODE = MODE_;
  static constexpr bool ASCII = ASCII_ && NW_ > 1;
  const uint64_t* __restrict__ cover;  // shared [256, NW]
  const uint64_t* __restrict__ rows;   // shared [G, S, NW]
  const uint64_t* __restrict__ mbs;    // shared [G, NW] (kLook)
  const uint64_t* __restrict__ sts;    // shared [Gs, NW] (kLook)
  const uint8_t* __restrict__ cls;     // shared [256] byte classes
  // the closure rows ORed by chunks of m (shared): word 0 of the rows of
  // each byte of m's word 0 (ASCII kernels), or each nibble of m's words
  // (NW <= 2)
  const uint64_t* __restrict__ chunks;
  int SN;                              // S * NW
  uint32_t gpack, spack;               // gmap, smap: 2 bits a context
  bool ascii;                          // the tables keep ASCII's promise
  uint64_t mb[NW], st[NW];             // mbits, startw (kFree)
  uint64_t a[NW];
  bool lazy;                           // a's words 1.. are stale
  uint64_t ml;                         // the last ASCII step's m
  int gl, sl;                          // and its closure and start group

  __device__ __forceinline__ int gmap(int ctx) const {
    return MODE == kFree ? 0 : (int)(gpack >> (2 * ctx)) & 3;
  }
  __device__ __forceinline__ int smap(int ctx) const {
    return MODE == kFree ? 0 : (int)(spack >> (2 * ctx)) & 3;
  }
  // word i of mbits[g] and of startw[s]
  __device__ __forceinline__ uint64_t mbit(int g, int i) const {
    return MODE == kLook ? mbs[g * NW + i] : mb[i];
  }
  __device__ __forceinline__ uint64_t stw(int s, int i) const {
    return MODE == kLook ? sts[s * NW + i] : st[i];
  }

  // words 1.. of the set after the last ASCII step, into x
  __device__ __forceinline__ void rest(uint64_t (&x)[NW]) const {
#pragma unroll
    for (int w = 1; w < NW; ++w) x[w] = stw(sl, w);
    const uint64_t* rg = rows + (size_t)gl * SN;
    uint64_t mm = ml;
    while (mm) {
      const uint64_t* r = rg + (__ffsll((long long)mm) - 1) * NW;
      mm &= mm - 1;
#pragma unroll
      for (int w = 1; w < NW; ++w) x[w] |= r[w];
    }
  }

  // One byte c in context ctx (unused without looks); returns its flag.
  __device__ __forceinline__ bool step(uint32_t c, int ctx) {
    const int g = gmap(ctx), s2 = smap(ctx);
    const uint64_t* rg = rows + (size_t)g * SN;
    if (ASCII && ascii && c < 128) {
      const uint64_t m = a[0] & cover[c * NW];
      uint64_t nx = stw(s2, 0);
      const uint64_t* bt = chunks + g * 8 * 256;  // [8 bytes of m][256]
      uint64_t mm = m;
      while (mm) {
        const int k = (__ffsll((long long)mm) - 1) >> 3;
        nx |= bt[k * 256 + (int)((mm >> (8 * k)) & 255)];
        mm &= ~(255ull << (8 * k));
      }
      a[0] = nx;
      lazy = true;
      ml = m;
      gl = g;
      sl = s2;
      return (m & mbit(g, 0)) != 0;
    }
    if (ASCII && lazy) {
      rest(a);
      lazy = false;
    }
    const uint64_t* cov = cover + c * NW;
    uint64_t m[NW], nx[NW];
    uint64_t hit = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      m[i] = a[i] & cov[i];
      hit |= m[i] & mbit(g, i);
      nx[i] = stw(s2, i);
    }
    if constexpr (NW <= 2 && !ASCII) {
      // a nibble of m an iteration, whichever word holds it: the rows of
      // up to 4 states at once from [NW words][16 nibbles][16 values][NW]
      const uint64_t* nt = chunks + g * NW * 256 * NW;
      uint64_t m0 = m[0], m1 = NW > 1 ? m[NW - 1] : 0;
      while (m0 | m1) {
        const bool lo = m0 != 0;
        const uint64_t v = lo ? m0 : m1;
        const int k = (__ffsll((long long)v) - 1) >> 2;
        const uint64_t* r =
            nt + (((lo ? 0 : 16) + k) * 16 + (int)((v >> (4 * k)) & 15)) * NW;
        const uint64_t clear = ~(15ull << (4 * k));
        m0 = lo ? m0 & clear : m0;
        m1 = lo ? m1 : m1 & clear;
#pragma unroll
        for (int w = 0; w < NW; ++w) nx[w] |= r[w];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        uint64_t mm = m[i];
        while (mm) {
          const uint64_t* r =
              rg + (i * 64 + __ffsll((long long)mm) - 1) * NW;
          mm &= mm - 1;
#pragma unroll
          for (int w = 0; w < NW; ++w) nx[w] |= r[w];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) a[i] = nx[i];
    return hit != 0;
  }

  __device__ __forceinline__ void load(const int64_t* __restrict__ src) {
#pragma unroll
    for (int i = 0; i < NW; ++i) a[i] = (uint64_t)src[i];
    lazy = false;
  }

  // The set as the plain version holds it.
  __device__ __forceinline__ void store(int64_t* __restrict__ dst) const {
    uint64_t x[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) x[i] = a[i];
    if (ASCII && lazy) rest(x);
#pragma unroll
    for (int i = 0; i < NW; ++i) dst[i] = (int64_t)x[i];
  }
};

// Steps the four bytes of word cur (walk-local positions q0 .. q0 + 3; nxt
// is the next word) that lie in [lo, hi), into flag word fw.
template <bool WHOLE, class WK>
__device__ __forceinline__ void step_word(WK& wk, uint32_t cur, uint32_t nxt,
                                          int q0, int eot, int lo, int hi,
                                          uint32_t& fw) {
  int cl[5];
  if (WK::MODE != kFree) {
#pragma unroll
    for (int b = 0; b < 4; ++b) cl[b] = wk.cls[(cur >> (8 * b)) & 255];
    cl[4] = wk.cls[nxt & 255];
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int q = q0 + b;
    if (!WHOLE && (q < lo || q >= hi)) continue;
    const uint32_t c = (cur >> (8 * b)) & 255;
    const int ctx = WK::MODE == kFree
                        ? 0 : cl[b] * 4 + (q == eot ? 3 : cl[b + 1]);
    if (wk.step(c, ctx)) fw |= 1u << (q & 31);
  }
}

// Walks words t0 .. t0 + nw - 1 of lane src from the walker's set, stepping
// the walk-local positions q (byte q of the walk, global position p0 + q)
// with skip <= q < lim.  With flagw, writes the flag word of each group of
// 8 words (at group t0/8 + g of lane src) and sums its flags into cnt and
// its last flag's position into last.
template <class WK>
__device__ __forceinline__ void walk(WK& wk, const int32_t* __restrict__ tiles,
                                     int T4, int L, int src, int t0, int nw,
                                     long long p0, long long n, int lim,
                                     int skip, int32_t* __restrict__ flagw,
                                     int& cnt, int& last) {
  const int tb = skip >> 2;
  const int te = min(nw, (lim + 3) >> 2);
  // walk-local position of the text's last byte (next class 3 after it)
  const long long e = n - 1 - p0;
  const int eot = e >= 0 && e < 4LL * nw ? (int)e : -1;
  // words t .. t + kAhead of the walk, in flight ahead of use
  uint32_t ring[kAhead + 1];
#pragma unroll
  for (int r = 0; r <= kAhead; ++r)
    ring[r] = tb < te ? word_at(tiles, T4, L, src, t0 + tb + r) : 0u;
  uint32_t fw = 0;
#pragma unroll 1
  for (int t = 0; t < nw; ++t) {
    if (t >= tb && t < te) {
      if (4 * t >= skip && 4 * t + 4 <= lim)
        step_word<true>(wk, ring[0], ring[1], 4 * t, eot, 0, 0, fw);
      else
        step_word<false>(wk, ring[0], ring[1], 4 * t, eot, skip, lim, fw);
#pragma unroll
      for (int r = 0; r < kAhead; ++r) ring[r] = ring[r + 1];
      ring[kAhead] = word_at(tiles, T4, L, src, t0 + t + kAhead + 1);
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
__device__ __forceinline__ void copy_set(int64_t* __restrict__ dst,
                                         const int64_t* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < NW; ++i) dst[i] = src[i];
}

template <int NW>
__device__ __forceinline__ bool same_set(const int64_t* __restrict__ x,
                                         const int64_t* __restrict__ y) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < NW; ++i) eq &= x[i] == y[i];
  return eq;
}

struct Args {
  const int32_t* tiles;
  int T4, L, W4, k;
  long long n;
  const int64_t* entries;
  const int32_t* offsets;
  const int32_t* limits;
  const int64_t* first;
  const int64_t* prev;
  int32_t* counts;
  int32_t* last;
  int64_t* exits;
  int64_t* sync;
  int32_t* flagw;
  int32_t* walked;
};

// Walker i of a pass: sub-lane (j, l) = (i / L, i % L), or lane i (kLane).
template <int PASS, class WK>
__device__ __forceinline__ void run_walker(WK& wk, const Args& x, int i) {
  constexpr int NW = WK::NW;
  const int T4 = x.T4, L = x.L, k = x.k;
  const int G8 = T4 / 8 / k;   // flag groups of a sub-lane
  const int Tk = G8 * 32;      // bytes of a sub-lane
  const long long T = 4LL * T4;

  if (PASS == kLane) {
    const int l = i;
    const int lim = x.limits[l];
    const int64_t* enter =
        l > 0 ? x.prev + ((size_t)(k - 1) * L + l - 1) * NW : x.first;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      const int64_t* want = j > 0 ? x.prev + ((size_t)(j - 1) * L + l) * NW
                                  : enter;
      bad |= sub_limit(lim, j, Tk) > 0 &&
             !same_set<NW>(x.sync + ((size_t)j * L + l) * NW, want);
    }
    if (!bad) {
      for (int j = 0; j < k; ++j) {
        const size_t s = ((size_t)j * L + l) * NW;
        copy_set<NW>(x.exits + s, x.prev + s);
      }
      return;
    }
    count_walker(x.walked);
    wk.load(enter);
    for (int j = 0; j < k; ++j) {
      const size_t s = (size_t)j * L + l;
      int cnt = 0, lst = -1;
      wk.store(x.sync + s * NW);
      walk(wk, x.tiles, T4, L, l, j * G8 * 8, G8 * 8,
           l * T + (long long)j * Tk, x.n, sub_limit(lim, j, Tk), 0, x.flagw,
           cnt, lst);
      x.counts[s] = cnt;
      x.last[s] = lst;
      wk.store(x.exits + s * NW);
    }
    return;
  }

  const int j = i / L, l = i - j * L;
  const int lim = sub_limit(x.limits[l], j, Tk);
  if (PASS == kSub) {
    const int64_t* want =
        j > 0 ? x.prev + (size_t)(i - L) * NW
              : (l > 0 ? x.prev + ((size_t)(k - 1) * L + l - 1) * NW
                       : x.first);
    if (lim == 0 || same_set<NW>(x.sync + (size_t)i * NW, want)) {
      copy_set<NW>(x.exits + (size_t)i * NW, x.prev + (size_t)i * NW);
      return;
    }
    count_walker(x.walked);
    wk.load(want);
  } else {
    // warmup over the W4 words before the sub-lane's first word
    wk.load(x.entries + (size_t)i * NW);
    const int off = j == 0 ? x.offsets[l] : 0;
    const int W4 = x.W4;
    if (off < 4 * W4) {
      const int src = j == 0 ? (l == 0 ? L - 1 : l - 1) : l;
      const int w0 = (j == 0 ? T4 : j * G8 * 8) - W4;
      int cnt = 0, lst = -1;
      walk(wk, x.tiles, T4, L, src, w0, W4, src * T + 4LL * w0, x.n, 4 * W4,
           off, nullptr, cnt, lst);
    }
  }
  wk.store(x.sync + (size_t)i * NW);
  int cnt = 0, lst = -1;
  walk(wk, x.tiles, T4, L, l, j * G8 * 8, G8 * 8, l * T + (long long)j * Tk,
       x.n, lim, 0, x.flagw, cnt, lst);
  x.counts[i] = cnt;
  x.last[i] = lst;
  wk.store(x.exits + (size_t)i * NW);
}

struct Tables {
  const int64_t* cover;
  const int64_t* rows;
  const int64_t* mbits;
  const int64_t* startw;
  const int32_t* gmap;
  const int32_t* smap;
  int S, G, Gs;
};

// Resident blocks a kernel of NW-word sets is built for: the registers it
// may take (64, 80, 64 a thread), from the walks timed at 1536 MiB.
constexpr int min_blocks(int NW) { return NW <= 2 ? 4 : NW <= 5 ? 3 : 4; }

template <int NW, int MODE, bool ASCII, int PASS>
__global__ void __launch_bounds__(kThreads, min_blocks(NW))
    bitset_kernel(Tables tb, Args x) {
  using WK = Walker<NW, MODE, ASCII>;
  extern __shared__ uint64_t smem[];
  const int S = tb.S, G = tb.G, Gs = tb.Gs;
  const int n_cover = 256 * NW, n_rows = G * S * NW, n_mb = G * NW,
            n_st = Gs * NW;
  uint64_t* s_cover = smem;
  uint64_t* s_rows = s_cover + n_cover;
  uint64_t* s_mb = s_rows + n_rows;
  uint64_t* s_st = s_mb + n_mb;
  uint64_t* s_chunks = s_st + n_st;
  uint8_t* s_cls = (uint8_t*)(s_chunks + chunk_words(NW, G, ASCII));
  for (int i = threadIdx.x; i < n_cover; i += blockDim.x)
    s_cover[i] = (uint64_t)tb.cover[i];
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x)
    s_rows[i] = (uint64_t)tb.rows[i];
  for (int i = threadIdx.x; i < n_mb; i += blockDim.x)
    s_mb[i] = (uint64_t)tb.mbits[i];
  for (int i = threadIdx.x; i < n_st; i += blockDim.x)
    s_st[i] = (uint64_t)tb.startw[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const bool word = (i >= 48 && i <= 57) || (i >= 65 && i <= 90) ||
                      i == 95 || (i >= 97 && i <= 122);
    s_cls[i] = word ? 1 : (i == 10 ? 2 : 0);
  }
  __syncthreads();
  // the chunk tables from the rows
  if (WK::ASCII) {
    for (int i = threadIdx.x; i < G * 8 * 256; i += blockDim.x) {
      const int g = i >> 11, k = (i >> 8) & 7, v = i & 255;
      uint64_t acc = 0;
      for (int j = 0; j < 8; ++j)
        if ((v >> j) & 1 && 8 * k + j < S)
          acc |= s_rows[((size_t)g * S + 8 * k + j) * NW];
      s_chunks[i] = acc;
    }
  } else if (NW <= 2) {
    for (int i = threadIdx.x; i < G * NW * 256; i += blockDim.x) {
      const int g = i / (NW * 256), k = (i >> 4) % (NW * 16), v = i & 15;
      for (int w = 0; w < NW; ++w) {
        uint64_t acc = 0;
        for (int j = 0; j < 4; ++j)
          if ((v >> j) & 1 && 4 * k + j < S)
            acc |= s_rows[((size_t)g * S + 4 * k + j) * NW + w];
        s_chunks[(size_t)i * NW + w] = acc;
      }
    }
  }
  // whether every state that takes a byte < 128 lies in word 0, as the
  // host's order promises when it fits
  int spread = 0;
  if (WK::ASCII)
    for (int i = threadIdx.x; i < 128 * (NW - 1); i += blockDim.x)
      spread |= s_cover[(i / (NW - 1)) * NW + 1 + i % (NW - 1)] != 0;
  spread = __syncthreads_or(spread);

  WK wk;
  wk.cover = s_cover;
  wk.rows = s_rows;
  wk.mbs = s_mb;
  wk.sts = s_st;
  wk.cls = s_cls;
  wk.chunks = s_chunks;
  wk.SN = S * NW;
  wk.ascii = !spread;
  wk.gpack = wk.spack = 0;
  if (MODE != kFree) {
    for (int c = 0; c < 12; ++c) {
      wk.gpack |= (uint32_t)tb.gmap[c] << (2 * c);
      wk.spack |= (uint32_t)tb.smap[c] << (2 * c);
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    wk.mb[i] = s_mb[i];
    wk.st[i] = s_st[i];
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (PASS == kLane ? x.L : x.k * x.L)) run_walker<PASS>(wk, x, i);
}

// The kernel of a pass for NW words in MODE, ASCII-specialised where asked
// and built (pass 0, NW >= 2), or null.
template <int NW, int MODE>
const void* pick(int pass, bool ascii) {
  if (pass == kFirst && ascii && NW > 1)
    return (const void*)bitset_kernel<NW, MODE, true, kFirst>;
  if (pass == kFirst)
    return (const void*)bitset_kernel<NW, MODE, false, kFirst>;
  if (pass == kSub) return (const void*)bitset_kernel<NW, MODE, false, kSub>;
  return (const void*)bitset_kernel<NW, MODE, false, kLane>;
}

}  // namespace

// The kernels are built in four translation units, nfa_scan_part<P>.cu
// (P = 1-4: no looks at NW 1-4 and 5-8, looks at NW 1-4 and 5-8), each
// this file with CGX_NFA_PART = P, so that nvcc builds them side by side
// (one unit took 67 s); the unit of this file alone holds the entry points.
#ifndef CGX_NFA_PART
#define CGX_NFA_PART 0
#endif
#define CGX_CAT(a, b) a##b
#define CGX_PART_KERNEL(p) CGX_CAT(cgx_nfa_part_kernel, p)

// Part p's kernel of `pass` for NW words, or null.
const void* CGX_PART_KERNEL(1)(int NW, int pass, bool ascii);
const void* CGX_PART_KERNEL(2)(int NW, int pass, bool ascii);
const void* CGX_PART_KERNEL(3)(int NW, int pass, bool ascii);
const void* CGX_PART_KERNEL(4)(int NW, int pass, bool ascii);

#if CGX_NFA_PART > 0
const void* CGX_PART_KERNEL(CGX_NFA_PART)(int NW, int pass, bool ascii) {
  constexpr int MODE = (CGX_NFA_PART - 1) / 2 == 0 ? kFree : kLook;
  constexpr int W0 = (CGX_NFA_PART - 1) % 2 * 4 + 1;
  switch (NW - W0) {
    case 0: return pick<W0, MODE>(pass, ascii);
    case 1: return pick<W0 + 1, MODE>(pass, ascii);
    case 2: return pick<W0 + 2, MODE>(pass, ascii);
    case 3: return pick<W0 + 3, MODE>(pass, ascii);
  }
  return nullptr;
}
#else
namespace {

// The kernel of `pass` for tables of NW words, G closure and Gs start
// groups in `mode` (DeviceBitsetNFA.mode), or null where the mode cannot
// walk them.
const void* kernel_for(int mode, int NW, int G, int Gs, int pass,
                       bool ascii) {
  if (NW < 1 || NW > 8 || G < 1 || G > 4 || Gs < 1 || Gs > 4 || pass < 0 ||
      pass > kLane || (mode == kFree && (G != 1 || Gs != 1)) ||
      (mode != kFree && mode != kLook))
    return nullptr;
  if (mode == kFree)
    return NW <= 4 ? CGX_PART_KERNEL(1)(NW, pass, ascii)
                   : CGX_PART_KERNEL(2)(NW, pass, ascii);
  return NW <= 4 ? CGX_PART_KERNEL(3)(NW, pass, ascii)
                 : CGX_PART_KERNEL(4)(NW, pass, ascii);
}

}  // namespace

extern "C" {

// Pass 0 (kFirst, with warmup) or a repair pass (kSub, kLane) of the
// bitset-NFA scan over k sub-lanes a lane, sets of NW = 1..8 words, by the
// kernel of table mode `mode` (kFree, kLook), pass 0's
// specialised on the ASCII word when `ascii` (the host packed every state
// that takes a byte < 128 into word 0; the kernel checks it).  Repair
// passes read prev and first and write exits, and zero then count
// *walked; pass 0 reads entries and offsets.
int cgx_bitset_scan(int pass, int mode, int ascii, const int64_t* cover,
                    const int64_t* rows, const int64_t* mbits,
                    const int64_t* startw, const int32_t* gmap,
                    const int32_t* smap, int S, int NW, int G, int Gs,
                    const int32_t* tiles, int T4, int L, int W4, int k, int n,
                    const int64_t* entries, const int32_t* offsets,
                    const int32_t* limits, const int64_t* first,
                    const int64_t* prev, int32_t* counts, int32_t* last,
                    int64_t* exits, int64_t* sync, int32_t* flagw,
                    int32_t* walked, void* stream) {
  const void* kernel = kernel_for(mode, NW, G, Gs, pass, ascii != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(S, NW, G, Gs, pass == kFirst && ascii != 0);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pass != kFirst) {
    e = cudaMemsetAsync(walked, 0, sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  Tables tb{cover, rows, mbits, startw, gmap, smap, S, G, Gs};
  Args x{tiles, T4,   L,      W4,   k,     n,    entries, offsets, limits,
         first, prev, counts, last, exits, sync, flagw,   walked};
  const long long walkers = pass == kLane ? L : (long long)k * L;
  void* params[] = {&tb, &x};
  e = cudaLaunchKernel(kernel, dim3((unsigned)((walkers + kThreads - 1) /
                                               kThreads)),
                       dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Pass 0's kernel for tables of S states, NW words, G closure and Gs start
// groups in `mode` (ASCII-specialised when `ascii`): info[0] its resident
// blocks of kThreads threads an SM, info[1] its registers a thread,
// info[2] its local-memory (spill) bytes a thread, info[3] kThreads.
int cgx_bitset_occupancy(int mode, int ascii, int S, int NW, int G, int Gs,
                         int* info) {
  const void* kernel = kernel_for(mode, NW, G, Gs, kFirst, ascii != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, NW, G, Gs, ascii != 0);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes at;
  if ((e = cudaFuncGetAttributes(&at, kernel)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel,
                                                    kThreads, smem);
  info[1] = at.numRegs;
  info[2] = (int)at.localSizeBytes;
  info[3] = kThreads;
  return (int)e;
}

}  // extern "C"
#endif
