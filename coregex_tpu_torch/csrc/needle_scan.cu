// Needle kernels K5-K7: threads walk lanes' bytes in order and match up to
// 65 needle slots of at most 13 NUL-free bytes, each as a masked compare of
// the 16-byte window at a position.
//
// Replaces three Pallas kernels of the JAX package:
//   K5 line_scan.py:_line_kernel   lines holding a needle hit (optionally
//      behind a (?m)^prefix): per-sub-lane count of the commits at the
//      sub-lane's newlines after its first, and the sub-lane-local maxima
//      lnl (last newline), lp (last valid line start), lh (last qualifying
//      hit) and mpre (last hit before the first newline); a running
//      maximum over the sub-lanes in corpus order (line_scan.line_verdict)
//      stitches each one's first line exactly.
//   K6 line_scan.py:_hits_kernel   raw hits of a literal set with exact
//      overlap detection: cnt, ov (a hit starts inside an earlier hit's
//      reach in the sub-lane), fh (first hit), reach (last covered
//      position), each sub-lane-local; a running maximum over the
//      sub-lanes in corpus order (line_scan.hits_verdict) finds the
//      overlaps across their seams.
//   K7 seq_scan.py:_seq_kernel     the sequential needle machine
//      (MODE_MULTI: leftmost-first countdown; MODE_LINE: prev_nl, valid,
//      seen and since-line-start bits) with K1's warmup and sync snapshot,
//      repaired by the passes of lane_scan.cu (count_scan.split_passes).
// The TPU kernels find hits with masked word compares over 4 byte phases x M
// words and turn K5/K6 into log-depth cummax trees over [Q, 8, Lc] planes,
// because a TPU core steps vectors, not lanes.  On Hopper the running maxima
// (or K7's state) are a few registers per thread, updated in position order.
//
// What bounds it on an H100: device-memory traffic is one read of the
// [T4, L] word tiles (adjacent lanes read adjacent words, so a warp load is
// one 128-byte line) plus 16 bytes of the next lane and, for K7, W bytes of
// the previous one.  Each thread's instruction chain per byte is the other
// bound, and a per-position step unrolled over many positions overflows the
// instruction caches, so the walk never steps positions one by one.  Per
// group of 8 words (32 positions) it requests the next group's words, then
// builds two masks with straight-line code: the candidates, from a
// 65,536-bit filter in shared memory keyed by a hash of the position's next
// 4 bytes, or by its next 2 when a needle is shorter than 4 (32 independent
// lookups), and the newlines.  Only set bits cost more: a candidate reads
// its window from the group's words staged in shared memory and searches
// the slots starting with its byte (a bucket table); then the events run in
// position order.
// K7's state moves in closed form across the quiet bytes between events.
// The work per byte thus grows with the share of candidate positions, not
// with J (multi_literal32 on the bench corpus: 9.1 % of positions pass a
// 2-byte filter, 3.4 % the 4-byte one, 2.9 % start a match).
// The 8192-lane geometry leaves about 62 threads per SM when one thread
// walks a lane, too few to cover that chain's latency.  So all three walk
// k sub-lanes a lane (count_scan.lane_split: 64 at 1536 MiB, 524,288
// walkers), the j-th of lane l over words j*T4/k .. (j+1)*T4/k - 1 with
// adjacent threads on adjacent lanes.  Their needle image (filter,
// buckets, slots) is built once per call by a one-block kernel into device
// memory and copied into each block's shared memory, not rebuilt by each
// of the 4096 blocks (K7: by its pass 0, and read by its repair passes).
// K5 and K6 need no fixpoint (their lanes carry no state, only running
// maxima of positions).  K7's sub-lanes warm up over the W bytes before
// them, and its repair passes walk only the unsettled sub-lanes, then the
// lanes holding one; a block none of whose threads walks returns before
// it copies the image.  In MODE_LINE a sub-lane whose live warmup bytes
// hold a newline is exact whatever its entry (the machine restarts at a
// line), so pass 0 marks it clean and no repair walks it again.
//
// Layouts (int32, little-endian bytes within a word):
//   tbl     [J, 8]   needle slot j: mask words 0-3, value words 0-3 of its
//                    16-byte window at phase 0; lens [J] its byte length
//   tiles   [T4, L]  word t of lane l = bytes l*T + 4t .. l*T + 4t + 3
//   K5 pnl and outputs, K6 outputs, K7 entries, prev and outputs [k, L]:
//   row j = sub-lanes (j, .); K5's pnl: the byte before sub-lane (j, l) is
//   a newline (set for (0, 0)); K7's offsets and limits [L], sub-lane j's
//   limit clamp(limits[l] - j*T/k, 0, T/k), its offset offsets[l] for j = 0
//   and 0 else
// Stream word idx of lane l: idx < 0 reads the previous lane's word T4 + idx
// (lane 0 reads lane L-1), idx >= T4 the next lane's word idx - T4 (zeros
// after the last lane).  A sub-lane's 16-byte look-ahead reads its own
// lane's next words, and the last one's the next lane's; K7's warmup reads
// the W/4 words before it, for j = 0 the previous lane's last ones (lane 0
// reads lane L-1's, which its offset of W skips).

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

using cgx::count_walker;
using cgx::sub_limit;

constexpr int kMaxSlots = 65;
constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;
constexpr int kThreads = 128;
constexpr int kMulti = 0;
enum Pass { kFirst = 0, kSub = 1, kLane = 2 };  // count_scan.PASS_*

struct Needles {
  uint64_t mlo[kMaxSlots], vlo[kMaxSlots], mhi[kMaxSlots], vhi[kMaxSlots];
  int len[kMaxSlots];
  // the candidate filter over slots [0, nbucket), 65,536 bits keyed by a
  // position's next bytes: when every such needle has 4 bytes or more, by
  // a multiplicative hash of the 4 bytes (quad); else by the 2 bytes
  // b0 | b1 << 8 (a one-byte needle sets all 256 pairs of its byte)
  uint32_t filter[2048];
  int quad;
  // slots [0, nbucket) grouped by first byte, in slot order within a group:
  // bucket[start[b] .. start[b + 1]) are the slots whose needle starts with b
  uint8_t bucket[kMaxSlots];
  uint8_t start[257];
};

// 16 bits of a multiplicative hash of 4 bytes (little-endian)
__device__ __forceinline__ uint32_t quad_key(uint32_t x) {
  return (x * 2654435761u) >> 16;
}

__device__ void load_needles(Needles& nd, const int32_t* __restrict__ tbl,
                             const int32_t* __restrict__ lens, int J,
                             int nbucket) {
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tbl + 8 * j);
    nd.mlo[j] = w[0] | ((uint64_t)w[1] << 32);
    nd.mhi[j] = w[2] | ((uint64_t)w[3] << 32);
    nd.vlo[j] = w[4] | ((uint64_t)w[5] << 32);
    nd.vhi[j] = w[6] | ((uint64_t)w[7] << 32);
    nd.len[j] = lens[j];
  }
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) nd.filter[i] = 0;
  if (threadIdx.x == 0) {
    int kmin = 4;
    for (int j = 0; j < nbucket; ++j) kmin = min(kmin, (int)lens[j]);
    nd.quad = kmin >= 4;
  }
  // start[b]: the slots whose first byte is below b
  for (int b = threadIdx.x; b <= 256; b += blockDim.x) {
    int c = 0;
    for (int j = 0; j < nbucket; ++j) c += (tbl[8 * j + 4] & 255) < b;
    nd.start[b] = (uint8_t)c;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nbucket; j += blockDim.x) {
    const uint32_t v = (uint32_t)tbl[8 * j + 4];
    const uint32_t b = v & 255;
    int r = nd.start[b];
    for (int i = 0; i < j; ++i) r += ((uint32_t)tbl[8 * i + 4] & 255) == b;
    nd.bucket[r] = (uint8_t)j;
    if (nd.quad) {
      const uint32_t key = quad_key(v);
      atomicOr(&nd.filter[key >> 5], 1u << (key & 31));
    } else if (lens[j] == 1) {
      for (uint32_t key = b; key < 65536; key += 256)
        atomicOr(&nd.filter[key >> 5], 1u << (key & 31));
    } else {
      const uint32_t key = v & 0xFFFF;
      atomicOr(&nd.filter[key >> 5], 1u << (key & 31));
    }
  }
  __syncthreads();
}

// K5's, K6's or K7's needle image in device memory: one block builds it
// once per call, the filter and buckets over slots [0, nbucket) (K5 and
// K7's MODE_LINE: the needles, not the anchored prefix slot jh, which is
// matched by its slot alone).
__global__ void needles_kernel(const int32_t* __restrict__ tbl,
                               const int32_t* __restrict__ lens, int J,
                               int nbucket, Needles* __restrict__ img) {
  load_needles(*img, tbl, lens, J, nbucket);
}

// Copies the image into a block's shared copy, 8 bytes a thread a step.
__device__ __forceinline__ void copy_needles(Needles& nd,
                                             const Needles* __restrict__ img) {
  static_assert(sizeof(Needles) % 8 == 0, "Needles copies as uint2");
  const uint2* src = reinterpret_cast<const uint2*>(img);
  uint2* dst = reinterpret_cast<uint2*>(&nd);
  for (int i = threadIdx.x; i < (int)(sizeof(Needles) / 8); i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ bool match(const Needles& nd, int j, uint64_t lo,
                                      uint64_t hi) {
  return ((lo & nd.mlo[j]) == nd.vlo[j]) && ((hi & nd.mhi[j]) == nd.vhi[j]);
}

__device__ __forceinline__ uint32_t stream_word(const int32_t* __restrict__ tiles,
                                                int T4, int L, int l, int idx) {
  if (idx < 0) {
    const int prev = (l == 0) ? L - 1 : l - 1;
    return (uint32_t)tiles[(size_t)(T4 + idx) * L + prev];
  }
  if (idx < T4) return (uint32_t)tiles[(size_t)idx * L + l];
  if (l + 1 >= L) return 0;
  return (uint32_t)tiles[(size_t)(idx - T4) * L + l + 1];
}

// The candidate filter's verdicts (cand) and the newline flags (nl) of the
// 32 positions of a group, bit 4j + k for byte k of word j; w holds the
// group's stream words g .. g + 11.  The filter's key is a template
// argument: the walk is bound by the instructions it runs, so no select.
template <bool Quad>
__device__ __forceinline__ void screen_keyed(const Needles& nd,
                                             const uint32_t (&w)[12],
                                             uint32_t& cand, uint32_t& nl) {
  cand = 0;
  nl = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = __funnelshift_r(w[j], w[j + 1], 8 * k);
      const uint32_t key = Quad ? quad_key(x) : x & 0xFFFF;
      cand |= ((nd.filter[key >> 5] >> (key & 31)) & 1) << (4 * j + k);
    }
    // 0x01 in each newline byte, gathered to 4 bits: byte k times
    // 0x01020408 lands on bit 24 + k, every cross term elsewhere
    const uint32_t eq = __vcmpeq4(w[j], 0x0A0A0A0Au) & 0x01010101u;
    nl |= ((eq * 0x01020408u) >> 24) << (4 * j);
  }
}

__device__ __forceinline__ void screen(const Needles& nd,
                                       const uint32_t (&w)[12],
                                       uint32_t& cand, uint32_t& nl) {
  if (nd.quad) {
    screen_keyed<true>(nd, w, cand, nl);
  } else {
    screen_keyed<false>(nd, w, cand, nl);
  }
}

// Calls f(g, w, valid) for the groups of 8 words g = t0, t0 + 8, .. < t1 in
// order: w holds the stream words g .. g + 11 and bit i of valid marks the
// positions 4g + i below 4 * t1.  A group's loads all go out together, and
// the next group's before f steps this one.
template <class F>
__device__ __forceinline__ void scan_groups(const int32_t* __restrict__ tiles,
                                            int T4, int L, int l, int t0,
                                            int t1, F&& f) {
  // the 8 words g + 4 .. g + 11 that the group starting at word g adds
  auto load8 = [&](uint32_t (&dst)[8], int g) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = g + j < t1 ? stream_word(tiles, T4, L, l, g + j + 4) : 0;
  };
  uint32_t w[12];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = stream_word(tiles, T4, L, l, t0 + j);
  uint32_t next[8];
  load8(next, t0);
  for (int g = t0; g < t1; g += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[4 + j] = next[j];
    load8(next, g + 8);
    f(g, w, t1 - g >= 8 ? ~0u : (1u << (4 * (t1 - g))) - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = w[8 + j];
  }
}

// Per-thread staging of a group's 12 words in shared memory, so that a
// position chosen at run time reads its window without indexing registers.
struct Stage {
  uint32_t* base;  // word j of this thread at base[j * kThreads]
  __device__ __forceinline__ void put(const uint32_t (&w)[12]) const {
#pragma unroll
    for (int j = 0; j < 12; ++j) base[j * kThreads] = w[j];
  }
  // the window lo/hi of bytes q .. q + 15 of the group (q < 32)
  __device__ __forceinline__ void window(int q, uint64_t& lo,
                                         uint64_t& hi) const {
    const int j = q >> 2, s = 8 * (q & 3);
    uint32_t v[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] = base[(j + i) * kThreads];
    lo = __funnelshift_r(v[0], v[1], s) |
         ((uint64_t)__funnelshift_r(v[1], v[2], s) << 32);
    hi = __funnelshift_r(v[2], v[3], s) |
         ((uint64_t)__funnelshift_r(v[3], v[4], s) << 32);
  }
};

// The first slot (in slot order) of [0, nbucket) that matches, or -1.
__device__ __forceinline__ int first_hit(const Needles& nd, uint64_t lo,
                                         uint64_t hi) {
  const int b = (int)(lo & 255);
  for (int i = nd.start[b]; i < nd.start[b + 1]; ++i) {
    const int j = nd.bucket[i];
    if (match(nd, j, lo, hi)) return j;
  }
  return -1;
}

__global__ void line_kernel(const Needles* __restrict__ img, int jh,
                            int anchored, int plen,
                            const int32_t* __restrict__ pnl,
                            const int32_t* __restrict__ tiles, int T4, int L,
                            int k, int32_t* __restrict__ cnt_o,
                            int32_t* __restrict__ lnl_o,
                            int32_t* __restrict__ lp_o,
                            int32_t* __restrict__ lh_o,
                            int32_t* __restrict__ mpre_o) {
  __shared__ Needles nd;
  __shared__ uint32_t st[12 * kThreads];
  copy_needles(nd, img);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * L) return;
  // sub-lane j of lane l: words t0 .. t0 + T4/k - 1, positions local to it
  const int j = i / L, l = i - j * L;
  const int t0 = j * (T4 / k);
  const Stage stage{st + threadIdx.x};
  // bit 0 of the next group's line starts: the byte before it is a newline
  uint32_t carry = pnl[i] != 0;
  int ln = kNeg, lh = kNeg, lp = kNeg, mpre = -1, cnt = 0;
  scan_groups(tiles, T4, L, l, t0, t0 + T4 / k,
              [&](int g, const uint32_t (&w)[12], uint32_t valid) {
    uint32_t cand, nl;
    screen(nd, w, cand, nl);
    cand &= valid;
    nl &= valid;
    const uint32_t starts = anchored ? ((nl << 1) | carry) & valid : 0;
    carry = nl >> 31;
    uint32_t hits = 0, lps = 0;
    if (cand | starts) {
      stage.put(w);
      for (uint32_t c = cand; c; c &= c - 1) {
        const int q = __ffs(c) - 1;
        uint64_t lo, hi;
        stage.window(q, lo, hi);
        if (first_hit(nd, lo, hi) >= 0) hits |= 1u << q;
      }
      for (uint32_t c = starts; c; c &= c - 1) {
        const int q = __ffs(c) - 1;
        uint64_t lo, hi;
        stage.window(q, lo, hi);
        if (match(nd, jh, lo, hi)) lps |= 1u << q;
      }
    }
    // the events in position order; a newline is never a hit or a start
    for (uint32_t e = hits | nl | lps; e; e &= e - 1) {
      const int q = __ffs(e) - 1;
      const int p = 4 * (g - t0) + q;
      if ((nl >> q) & 1) {
        cnt += (lh > ln && ln >= 0 && (!anchored || lp > ln)) ? 1 : 0;
        ln = p;
        continue;
      }
      if ((hits >> q) & 1) {
        if (ln < 0) mpre = p;
        if (!anchored || (ln >= 0 && p - ln - 1 >= plen)) lh = p;
      }
      if ((lps >> q) & 1) lp = p;
    }
  });
  cnt_o[i] = cnt;
  lnl_o[i] = ln;
  lp_o[i] = lp;
  lh_o[i] = lh;
  mpre_o[i] = mpre;
}

__global__ void hits_kernel(const Needles* __restrict__ img,
                            const int32_t* __restrict__ tiles, int T4, int L,
                            int k, int32_t* __restrict__ cnt_o,
                            int32_t* __restrict__ ov_o,
                            int32_t* __restrict__ fh_o,
                            int32_t* __restrict__ reach_o) {
  __shared__ Needles nd;
  __shared__ uint32_t st[12 * kThreads];
  copy_needles(nd, img);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * L) return;
  // sub-lane j of lane l: words t0 .. t0 + T4/k - 1, positions local to it
  const int j = i / L, l = i - j * L;
  const int t0 = j * (T4 / k);
  const Stage stage{st + threadIdx.x};
  int run = kNeg, ov = 0, cnt = 0, fh = kBig;
  scan_groups(tiles, T4, L, l, t0, t0 + T4 / k,
              [&](int g, const uint32_t (&w)[12], uint32_t valid) {
    uint32_t cand, nl;
    screen(nd, w, cand, nl);
    cand &= valid;
    if (!cand) return;
    stage.put(w);
    for (; cand; cand &= cand - 1) {
      const int q = __ffs(cand) - 1;
      uint64_t lo, hi;
      stage.window(q, lo, hi);
      const int b = (int)(lo & 255);
      int best = 0;
      for (int s = nd.start[b]; s < nd.start[b + 1]; ++s) {
        const int jn = nd.bucket[s];
        if (match(nd, jn, lo, hi)) best = max(best, nd.len[jn]);
      }
      if (best) {
        const int p = 4 * (g - t0) + q;
        ov |= (run >= p) ? 1 : 0;
        ++cnt;
        if (fh == kBig) fh = p;
        run = max(run, p + best - 1);
      }
    }
  });
  cnt_o[i] = cnt;
  ov_o[i] = ov;
  fh_o[i] = fh;
  reach_o[i] = run;
}

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// K7's machine over one sub-lane of lane l: stream words b0 - w4 .. of the
// lane, from state s.  Positions count from the sub-lane's first byte (word
// b0), the w4 warmup words before it are negative; positions below live0
// or at or above lim leave the state alone.  Returns the exit state; cnt
// gets the commits at positions >= 0, sy the state at position 0, and nlw
// whether a live warmup position holds a newline (MODE_LINE: the sub-lane
// is then exact whatever s).
__device__ __forceinline__ int seq_walk(const Needles& nd, const Stage& stage,
                                        int mode, int jh, int anchored,
                                        int plen,
                                        const int32_t* __restrict__ tiles,
                                        int T4, int L, int l, int b0, int w4,
                                        int live0, int lim, int s, int& cnt,
                                        int& sy, bool& nlw) {
  const bool simple = mode != kMulti && !anchored && plen == 0;
  const int t1 = b0 + (lim > 0 ? (lim + 3) / 4 : 0);
  sy = s;
  // s is the state after the positions below `at`.  Between events the
  // state moves in closed form: a quiet live byte (no hit, no newline, not
  // a line start) counts MODE_MULTI's countdown down and the since-line-
  // start counter up, and leaves every other bit alone.
  int at = -4 * w4;
  auto quiet = [&](int p) {  // the quiet positions at .. p - 1
    const int n = min(p, lim) - max(at, live0);
    if (n > 0) {
      if (mode == kMulti) {
        s = max(s - n, 0);
      } else if (!simple) {
        s = (s & ~(31 << 3)) | (min(((s >> 3) & 31) + n, 31) << 3);
      }
    }
    at = p;
  };
  auto advance = [&](int p) {
    if (at < 0 && p >= 0) {  // the sync snapshot after position -1
      quiet(0);
      sy = s;
    }
    quiet(p);
  };
  // one position's step: j is its first matching slot or -1
  auto step = [&](int cb, int q, int j, int nl) {
    bool commit;
    int ns;
    if (mode == kMulti) {
      const int wl = j >= 0 ? nd.len[j] : 0;
      commit = wl > 0 && s == 0;
      ns = commit ? wl - 1 : max(s - 1, 0);
    } else {
      const bool hit = j >= 0;
      const bool prev_nl = s & 1;
      bool seen = ((s >> 2) & 1) && !prev_nl;
      if (simple) {
        commit = hit && !seen;
        seen = seen || commit;
        ns = nl | ((int)seen << 2);
      } else {
        bool valid = (s >> 1) & 1;
        int slc = (s >> 3) & 31;
        if (anchored) {
          if (prev_nl) {
            uint64_t lo, hi;
            stage.window(q, lo, hi);
            valid = match(nd, jh, lo, hi);
          }
        } else {
          valid = valid || prev_nl;
        }
        slc = prev_nl ? 0 : min(slc + 1, 31);
        commit = hit && valid && !seen && slc >= plen;
        seen = seen || commit;
        ns = nl | ((int)valid << 1) | ((int)seen << 2) | (slc << 3);
      }
    }
    if (cb >= live0 && cb < lim) {
      s = ns;
      if (cb >= 0 && commit) ++cnt;
    }
    if (cb == -1) sy = s;
    at = cb + 1;
  };
  uint32_t carry = 0;  // the last byte of the previous group is a newline
  scan_groups(tiles, T4, L, l, b0 - w4, t1,
              [&](int g, const uint32_t (&w)[12], uint32_t in_range) {
    uint32_t cand, nls;
    screen(nd, w, cand, nls);
    const int pb = 4 * (g - b0);  // the position of the group's first byte
    if (mode != kMulti && pb < 0) {
      // the live warmup positions max(live0, pb) .. -1 of the group
      const int lo = max(live0 - pb, 0), hi = min(-pb, 32);
      if (lo < hi)
        nlw |= (nls & (uint32_t)((1ull << hi) - (1ull << lo))) != 0;
    }
    // events: candidates, and in line mode newlines, the positions after
    // them and the first live position (whose prev_nl is the entry's)
    uint32_t ev = cand;
    if (mode != kMulti) {
      ev |= nls | (nls << 1) | carry;
      carry = nls >> 31;
      const int f = live0 - pb;
      if (f >= 0 && f < 32) ev |= 1u << f;
    }
    ev &= in_range;
    if (!ev) return;
    stage.put(w);
    for (; ev; ev &= ev - 1) {
      const int q = __ffs(ev) - 1;
      // MODE_MULTI: a candidate inside a match is a quiet byte, so the
      // state comes first and the needle search only when it is 0
      advance(pb + q);
      if (mode == kMulti && s != 0) continue;
      int j = -1;
      if ((cand >> q) & 1) {
        uint64_t lo, hi;
        stage.window(q, lo, hi);
        j = first_hit(nd, lo, hi);
      }
      if (mode == kMulti && j < 0) continue;
      step(pb + q, q, j, (nls >> q) & 1);
    }
  });
  advance(4 * (t1 - b0));
  return s;
}

// K7 over k sub-lanes a lane, one pass of the split fixpoint (the passes
// of lane_scan.cu).  kFirst: sub-lane (j, l) warms up over the W4 words
// before it from entries, then walks its own; clean = the sub-lane is
// exact whatever its entry ((0, 0), and in line mode a newline among its
// live warmup bytes).  kSub: each unsettled sub-lane (real, not clean, its
// sync unlike the previous sub-lane's exit in prev) walks from that exit
// with no warmup.  kLane: each lane holding one walks whole from the
// previous lane's exit (a clean sub-lane 0 from its own sync).  Settled
// threads copy their exit; a block whose threads are all settled returns
// before it copies the needle image.
template <int PASS>
__global__ void __launch_bounds__(kThreads) seq_kernel(
    int mode, const Needles* __restrict__ img, int jh, int anchored,
    int plen, const int32_t* __restrict__ tiles, int T4, int L, int W4,
    int k, const int32_t* __restrict__ entries,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ limits,
    int first, const int32_t* __restrict__ prev, int32_t* __restrict__ counts,
    int32_t* __restrict__ exits, int32_t* __restrict__ sync,
    int32_t* __restrict__ clean, int32_t* __restrict__ walked) {
  __shared__ Needles nd;
  __shared__ uint32_t st[12 * kThreads];
  const int T4k = T4 / k, Tk = 4 * T4k;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool go = i < (PASS == kLane ? L : k * L);
  int s = 0;
  if (go && PASS == kSub) {
    const int j = i / L, l = i - j * L;
    const int want =
        j > 0 ? prev[i - L] : (l > 0 ? prev[(size_t)(k - 1) * L + l - 1] : first);
    go = sub_limit(limits[l], j, Tk) > 0 && !clean[i] && sync[i] != want;
    if (!go) exits[i] = prev[i];
    s = want;
  } else if (go && PASS == kLane) {
    const int l = i;
    const int enter = l > 0 ? prev[(size_t)(k - 1) * L + l - 1] : first;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      const size_t ij = (size_t)j * L + l;
      const int want = j > 0 ? prev[ij - L] : enter;
      bad |= sub_limit(limits[l], j, Tk) > 0 && !clean[ij] && sync[ij] != want;
    }
    go = bad;
    if (!go) {
      for (int j = 0; j < k; ++j) exits[(size_t)j * L + l] = prev[(size_t)j * L + l];
    }
    s = clean[l] ? sync[l] : enter;
  }
  if (!__syncthreads_or(go)) return;
  copy_needles(nd, img);
  if (!go) return;
  if (PASS != kFirst) count_walker(walked);
  const Stage stage{st + threadIdx.x};
  int sy;
  bool nlw = false;
  if (PASS == kLane) {
    const int l = i;
    for (int j = 0; j < k; ++j) {
      const size_t ij = (size_t)j * L + l;
      int cnt = 0;
      sync[ij] = s;
      s = seq_walk(nd, stage, mode, jh, anchored, plen, tiles, T4, L, l,
                   j * T4k, 0, 0, sub_limit(limits[l], j, Tk), s, cnt, sy,
                   nlw);
      counts[ij] = cnt;
      exits[ij] = s;
    }
    return;
  }
  const int j = i / L, l = i - j * L;
  const int lim = sub_limit(limits[l], j, Tk);
  int cnt = 0;
  if (PASS == kSub) {
    s = seq_walk(nd, stage, mode, jh, anchored, plen, tiles, T4, L, l,
                 j * T4k, 0, 0, lim, s, cnt, sy, nlw);
  } else {
    // positions below live0 leave the state alone: the warmup an offset
    // skips (sub-lane (0, l) only); all of it skips no word
    const int live0 = (j == 0 ? offsets[l] : 0) - 4 * W4;
    s = seq_walk(nd, stage, mode, jh, anchored, plen, tiles, T4, L, l,
                 j * T4k, live0 >= 0 ? 0 : W4, live0, lim, entries[i], cnt,
                 sy, nlw);
    clean[i] = i == 0 || (mode != kMulti && nlw);
  }
  counts[i] = cnt;
  exits[i] = s;
  sync[i] = sy;
}

template <int PASS>
int seq_launch(int mode, const Needles* img, int jh, int anchored, int plen,
               const int32_t* tiles, int T4, int L, int W4, int k,
               const int32_t* entries, const int32_t* offsets,
               const int32_t* limits, int first, const int32_t* prev,
               int32_t* counts, int32_t* exits, int32_t* sync, int32_t* clean,
               int32_t* walked, cudaStream_t st) {
  if (PASS != kFirst) {
    const cudaError_t e = cudaMemsetAsync(walked, 0, sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  seq_kernel<PASS><<<blocks_for(PASS == kLane ? L : k * L), kThreads, 0, st>>>(
      mode, img, jh, anchored, plen, tiles, T4, L, W4, k, entries, offsets,
      limits, first, prev, counts, exits, sync, clean, walked);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5 over k sub-lanes a lane: builds the needle image into img (the
// filter and buckets over the jh needles), then walks; pnl and outputs
// [k, L].
int cgx_line_lanes(const int32_t* tbl, const int32_t* lens, int J, int jh,
                   int anchored, int plen, const int32_t* pnl,
                   const int32_t* tiles, int T4, int L, int k, void* img,
                   int32_t* cnt, int32_t* lnl, int32_t* lp, int32_t* lh,
                   int32_t* mpre, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Needles* nd = reinterpret_cast<Needles*>(img);
  needles_kernel<<<1, kThreads, 0, st>>>(tbl, lens, J, jh, nd);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  line_kernel<<<blocks_for(k * L), kThreads, 0, st>>>(
      nd, jh, anchored, plen, pnl, tiles, T4, L, k, cnt, lnl, lp, lh, mpre);
  return (int)cudaGetLastError();
}

// Bytes of the needle image (the img buffer of cgx_line_lanes,
// cgx_hits_lanes and cgx_seq_lanes).
int cgx_needles_bytes(void) { return (int)sizeof(Needles); }

// K6 over k sub-lanes a lane: builds the needle image into img, then walks;
// outputs [k, L].
int cgx_hits_lanes(const int32_t* tbl, const int32_t* lens, int J,
                   const int32_t* tiles, int T4, int L, int k, void* img,
                   int32_t* cnt, int32_t* ov, int32_t* fh, int32_t* reach,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Needles* nd = reinterpret_cast<Needles*>(img);
  needles_kernel<<<1, kThreads, 0, st>>>(tbl, lens, J, J, nd);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hits_kernel<<<blocks_for(k * L), kThreads, 0, st>>>(nd, tiles, T4, L, k,
                                                      cnt, ov, fh, reach);
  return (int)cudaGetLastError();
}

// K7, one pass over k sub-lanes a lane: kFirst (0) builds the needle image
// into img (the filter and buckets over the J needles in MODE_MULTI, the
// jh needles in MODE_LINE), then walks with warmup and writes clean; kSub
// (1) and kLane (2) read img, clean and prev, write exits, and zero then
// count *walked.  Entries, prev and outputs [k, L].
int cgx_seq_lanes(int pass, int mode, const int32_t* tbl, const int32_t* lens,
                  int J, int jh, int anchored, int plen, const int32_t* tiles,
                  int T4, int L, int W4, int k, const int32_t* entries,
                  const int32_t* offsets, const int32_t* limits, int first,
                  const int32_t* prev, void* img, int32_t* counts,
                  int32_t* exits, int32_t* sync, int32_t* clean,
                  int32_t* walked, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Needles* nd = reinterpret_cast<Needles*>(img);
  if (pass == kFirst) {
    needles_kernel<<<1, kThreads, 0, st>>>(tbl, lens, J,
                                           mode == kMulti ? J : jh, nd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
#define CGX_SEQ(P)                                                          \
  return seq_launch<P>(mode, nd, jh, anchored, plen, tiles, T4, L, W4, k,   \
                       entries, offsets, limits, first, prev, counts, exits, \
                       sync, clean, walked, st)
  if (pass == kFirst) CGX_SEQ(kFirst);
  if (pass == kSub) CGX_SEQ(kSub);
  CGX_SEQ(kLane);
#undef CGX_SEQ
}

}  // extern "C"
