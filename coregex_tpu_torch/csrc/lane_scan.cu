// Lane-walk kernels K1-K3, K9 and the reset scan: the corpus splits into L
// lanes of T bytes and each lane walks its bytes through a packed
// transition table.
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
// and one lax.scan loop with no Pallas kernel:
//   reset dfa_scan.py:_chunk_scan_reset (:685, repaired by a while_loop at
//                                   :771, behind ResetScanner :781)
//                                   value = delta*32 + match over an S x C
//                                   table (C <= 32); each byte is
//                                   column << 3 | ctx << 1 | reset, ctx the
//                                   context of the byte before.  A reset
//                                   counts interference when the state is
//                                   live (not DEAD = 0), then restarts at
//                                   starts[ctx] (kept in registers); the
//                                   flag is the match bit.  The restart
//                                   stays a branch in the walker, not a
//                                   2C-column table as K3's (its 4 starts
//                                   differ, and run_gap_x's 1024 x 32
//                                   table would pass shared memory)
// The TPU kernels walk a select tree over a row/column-merged table because
// Mosaic has no dynamic gather; here the packed table sits in shared memory
// and each byte costs one or two shared-memory loads.  Every mode also has
// a global-memory instance, whose table is read with __ldg, through L1 and
// L2, while the byte map stays in shared memory.
//
// What bounds it on an H100: each byte is a dependent chain (byte extract,
// the byte's column, the table load, the shift to the next state), so one
// walker advances one byte per shared-memory latency.  The work is about
// ten instructions and one or two shared loads a byte: at 1,610,608,640
// bytes over 132 SMs that is about 0.5 ms of instruction issue, against
// 0.48 ms to read the bytes once.  The card reaches that only with enough
// walkers to cover the chain's latency: plan_geometry gives 8192 lanes, 62
// threads an SM, and one thread a lane ran 30x above the bound.  So every
// mode splits each lane into k consecutive sub-lanes
// (count_scan.lane_split: k = 64 at 1536 MiB, 524,288 walkers), each
// warming up over the W bytes before it; the repair passes then fix the
// k-times more seams, walking only the sub-lanes (or, after a few passes,
// whole lanes) whose entry differs from their predecessor's exit.
//
// Table residency.  A keyword list of 25-400 words gives tables of 30-330
// KB as int32, so one copy a block of 128 threads leaves 4-24 warps of an
// SM resident: too few walkers for the chain.  Three things keep them:
//   - 16-bit values: every mode's value is delta*32 + 5 flag bits, which
//     fits 16 bits while the table has at most kMax16 rows, so the host
//     packs such a table as int16 (read here as uint16_t) and it takes
//     half the room; a larger one stays int32 (the element type V is a
//     template parameter), and the shared-memory copy skews its rows
//     (pitch_of): a row of 64 columns spans whole banks, so walkers that
//     read one hot column (a space, a vowel) from different states meet in
//     one bank; a row pitch of an odd number of words sends each row's
//     column to another bank.  Unskewed, an int32 table walked 3-8 %
//     faster than a 16-bit one at equal warps; skewed, the 16-bit table
//     walks as fast and keeps twice the warps (PERF.md, section 6);
//   - a block size set by the table for every mode: 128 to 1024 threads,
//     the one that keeps the most walkers resident by the occupancy
//     calculator (block_threads), so one copy of the table serves up to 32
//     warps; the headline tables keep 128 threads, 16 blocks an SM;
//   - the instance chosen by resident warps, not by fit (use_shared):
//     the shared-memory instance where it keeps at least kMinSharedWarps
//     warps an SM (by lane_warps, an exact model of the occupancy at 32
//     registers a thread that count_scan.lane_warps mirrors), else global
//     memory: with 32 warps an SM in shared memory KW400's tables walked
//     1.3x faster than from global memory with 64, and with 4-12 warps
//     (128-thread blocks) 1.5-5x slower.
// __launch_bounds__(kMaxThreads, 2) holds pass 0 and the sub-lane pass to
// 32 registers, so registers never cap their walkers below the shared
// memory's cap; the whole-lane pass, few walkers, takes up to 64.

// Device-memory traffic is one read of the word tiles (plus n/16 bytes of
// flag words for K2/K3): sub-lane (j, l) reads words j*T4/k .. of lane l,
// and adjacent threads take adjacent lanes of the time-major [T4, L]
// layout, so each warp load is one 128-byte line.  Each thread issues the
// 8 loads of a 32-position group before stepping through them.
//
// Layouts (int32, little-endian bytes within a word):
//   tiles   [T4, L]     word t of lane l = bytes l*T + 4t .. l*T + 4t + 3
//   flagw   [T4/8, L]   bit 4*(t%8)+k of word t/8 = position 4t+k of the lane;
//                       sub-lane j owns groups j*T4/(8k) .. (j+1)*T4/(8k) - 1
//   counts, exits, sync, entries  [k, L]: row j = sub-lanes (j, .)
//   offsets, limits  [L]; sub-lane j's limit = clamp(limits[l] - j*T/k, 0, T/k)
//   K9: counts = set flags of the sub-lane, aux [k, L] = the sub-lane-local
//   position of its last set flag (-1 if none), so callers need no pass
//   over the words
//   reset: counts = resets that met a live state; segmap = starts [4]
// First pass: sub-lane (j, l) steps the W4 words before its own first word
// (j = 0: lane l-1's last W4 words, lane 0 reading lane L-1's, which its
// offset of W skips; the offset skips warmup position p < offsets[l] for
// j = 0 only), then its own words; `sync` is the state after warmup,
// `exits` the state after the sub-lane.  W4 = 0 walks no warmup: entries
// are the states at the sub-lanes' starts (K3's cached hint).  Positions
// past a limit leave the state frozen and emit nothing.
// Repair passes read `prev`, the previous pass's exits, and write `exits`
// (a second buffer).  A sub-lane is unsettled when it is real (limit > 0)
// and its sync differs from the previous sub-lane's exit (`first`, the
// true start state, for sub-lane (0, 0); DEAD for K3 and the reset mode,
// which hold no run before their first reset).  kSub: each unsettled sub-lane
// walks its words from that exit, with no warmup.  kLane: each lane holding
// an unsettled sub-lane walks whole from the previous lane's exit, writing
// every sub-lane's sync, counts, exits and flag groups.  Settled ones, and
// the ones past the corpus, which nothing reads, keep theirs and copy their
// exit; `walked` counts the walkers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

using cgx::count_walker;
using cgx::sub_limit;

enum Mode { kCount = 0, kSpan = 1, kFlag = 2, kMatch = 3, kReset = 4 };
enum Pass { kFirst = 0, kSub = 1, kLane = 2 };

constexpr int kThreads = 128;       // the smallest block
constexpr int kMaxThreads = 1024;   // the largest block
// the most dynamic shared memory a block takes (count_scan.SMEM_LIMIT)
constexpr size_t kSmemLimit = 232448;
// an SM's shared memory, the part of it each block reserves, and its unit
// of allocation (count_scan.SM_SMEM, BLOCK_RESERVED, SMEM_UNIT)
constexpr size_t kSmemPerSM = 233472;
constexpr size_t kBlockReserved = 1024;
constexpr size_t kSmemUnit = 128;
constexpr int kMaxBlocksPerSM = 32;
constexpr int kMaxThreadsPerSM = 2048;
// the fewest resident warps an SM for which a table takes the
// shared-memory instance (count_scan.MIN_SHARED_WARPS)
constexpr int kMinSharedWarps = 32;
// the most rows of a 16-bit table: its values delta*32 + 31 stay below
// 2^16 (count_scan.MAX16_ROWS)
constexpr int kMax16 = 2047;

// A launch's place for the table: by the rule (use_shared), or, where a
// caller asks for one to hold it against the plain version, global or
// shared memory
enum Place { kByRule = -1, kGlobal = 0, kShared = 1 };

// The walk's table of element type E (int32_t, or uint16_t for a 16-bit
// table): in shared memory (SMEM) or global memory.
template <int MODE, bool SMEM, typename E>
struct Table {
  const E* tbl;
  const int32_t* seg;
  int pitch;                // values a row
  int st0, st1, st2, st3;   // reset mode: the start state by context

  __device__ __forceinline__ int load(int i) const {
    return SMEM ? (int)tbl[i] : (int)__ldg(tbl + i);
  }

  // The packed value at byte b from state s.  The reset mode first
  // restarts at the start state of b's context when b's reset bit is set,
  // adding 1 to hit when the run it cuts is live.
  __device__ __forceinline__ int step(int s, int b, int& hit) const {
    if (MODE == kReset) {
      if (b & 1) {
        hit += s != 0;
        const int c = (b >> 1) & 3;
        s = c == 0 ? st0 : c == 1 ? st1 : c == 2 ? st2 : st3;
      }
      return load(s * pitch + (b >> 3));
    }
    return load(s * pitch + (MODE == kFlag ? b : seg[b]));
  }
};

// One packed value's outputs at bit `bit` of its group (the reset mode's
// count is step's `hit`).
template <int MODE>
__device__ __forceinline__ void take(int v, int bit, int& cnt, uint32_t& fw,
                                     uint32_t& gw) {
  if (MODE == kCount) {
    cnt += v & 31;
  } else if (MODE == kSpan) {
    cnt += (v >> 2) & 7;
    fw |= (uint32_t)(v & 1) << bit;
    gw |= (uint32_t)((v >> 1) & 1) << bit;
  } else if (MODE == kFlag) {
    cnt += (v >> 1) & 1;
    fw |= (uint32_t)(v & 1) << bit;
  } else {
    fw |= (uint32_t)(v & 1) << bit;
  }
}

// Walks groups g0 .. g0+G-1 of lane l from state s over positions < lim
// (counted from group g0), writing each group's flag words; returns the
// exit state.  `last` is the walk-local position of the last set flag
// (kMatch).
template <int MODE, class Tb>
__device__ __forceinline__ int walk(const Tb& t,
                                    const int32_t* __restrict__ tiles, int L,
                                    int l, int g0, int G, int lim, int s,
                                    int& cnt, int& last,
                                    int32_t* __restrict__ flagw,
                                    int32_t* __restrict__ firstw) {
  for (int g = 0; g < G; ++g) {
    uint32_t fw = 0, gw = 0;
    if (g * 32 < lim) {
      const int32_t* src = tiles + (size_t)(g0 + g) * 8 * L + l;
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = (uint32_t)src[(size_t)j * L];
      if (g * 32 + 32 <= lim) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int v = t.step(s, (w[j] >> (8 * k)) & 255, cnt);
            take<MODE>(v, j * 4 + k, cnt, fw, gw);
            s = v >> 5;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (g * 32 + j * 4 + k < lim) {
              const int v = t.step(s, (w[j] >> (8 * k)) & 255, cnt);
              take<MODE>(v, j * 4 + k, cnt, fw, gw);
              s = v >> 5;
            }
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
    if (MODE != kCount) flagw[(size_t)(g0 + g) * L + l] = (int32_t)fw;
    if (MODE == kSpan) firstw[(size_t)(g0 + g) * L + l] = (int32_t)gw;
  }
  return s;
}

// The row pitch (values a row) of an nseg-column table of `width`-byte
// values in shared memory (count_scan.lane_pitch): nseg, rounded up to an
// odd number of words a row where the row would span whole words (int32:
// an odd nseg; 16-bit: an odd nseg, or one of 2 mod 4).
__host__ __device__ __forceinline__ int pitch_of(int nseg, int width) {
  if (width == 4) return nseg | 1;
  return (nseg & 1) || (nseg & 3) == 2 ? nseg : nseg + 2;
}

// Bytes of S rows of `pitch` `width`-byte values in shared memory, padded
// to whole words.
__host__ __device__ __forceinline__ size_t table_bytes(int S, int pitch,
                                                       int width) {
  return ((size_t)S * pitch * width + 3) & ~(size_t)3;
}

// Pass 0 and the sub-lane pass keep 32 registers a thread (two blocks of
// kMaxThreads), so registers never cap their walkers below the shared
// memory's cap; the whole-lane pass, one walker a lane (8,192 at most),
// takes up to 64 and spills nothing.
template <int MODE, int PASS, bool SMEM, typename V>
__global__ void __launch_bounds__(kMaxThreads, PASS == kLane ? 1 : 2)
lane_walk_kernel(
    const V* __restrict__ packed, int S, int nseg, int pitch,
    const int32_t* __restrict__ segmap, const int32_t* __restrict__ tiles,
    int T4, int L, int W4, int k, const int32_t* __restrict__ entries,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ limits,
    int first, const int32_t* __restrict__ prev, int32_t* __restrict__ counts,
    int32_t* __restrict__ exits, int32_t* __restrict__ sync,
    int32_t* __restrict__ flagw, int32_t* __restrict__ aux,
    int32_t* __restrict__ walked) {
  extern __shared__ int32_t smem[];
  // the table's words in shared memory (rows of `pitch` values, the
  // padding never read), then the byte map
  const int nwords =
      SMEM ? (int)(table_bytes(S, pitch, (int)sizeof(V)) / 4) : 0;
  Table<MODE, SMEM, V> t{SMEM ? reinterpret_cast<const V*>(smem) : packed,
                         smem + nwords, SMEM ? pitch : nseg, 0, 0, 0, 0};
  if (SMEM) {
    V* dst = reinterpret_cast<V*>(smem);
    for (int i = threadIdx.x; i < S * nseg; i += blockDim.x) {
      const int r = i / nseg;
      dst[r * pitch + (i - r * nseg)] = packed[i];
    }
  }
  if (MODE == kReset) {
    t.st0 = segmap[0];
    t.st1 = segmap[1];
    t.st2 = segmap[2];
    t.st3 = segmap[3];
  } else if (MODE != kFlag) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      smem[nwords + i] = segmap[i];
  }
  __syncthreads();

  const int G = T4 / 8 / k;   // groups of a sub-lane
  const int Tk = G * 32;      // bytes of a sub-lane
  int32_t* firstw = MODE == kSpan ? aux : nullptr;

  if (PASS == kLane) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int lim = limits[l];
    const int enter = l > 0 ? prev[(size_t)(k - 1) * L + l - 1] : first;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      const int want = j > 0 ? prev[(size_t)(j - 1) * L + l] : enter;
      bad |= sub_limit(lim, j, Tk) > 0 && sync[(size_t)j * L + l] != want;
    }
    if (!bad) {
      for (int j = 0; j < k; ++j) exits[(size_t)j * L + l] = prev[(size_t)j * L + l];
      return;
    }
    count_walker(walked);
    int s = enter;
    for (int j = 0; j < k; ++j) {
      const size_t i = (size_t)j * L + l;
      int cnt = 0, last = -1;
      sync[i] = s;
      s = walk<MODE>(t, tiles, L, l, j * G, G, sub_limit(lim, j, Tk), s, cnt,
                     last, flagw, firstw);
      counts[i] = cnt;
      exits[i] = s;
      if (MODE == kMatch) aux[i] = last;
    }
    return;
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * L) return;
  const int j = i / L, l = i - j * L;
  const int lim = sub_limit(limits[l], j, Tk);
  int s;
  if (PASS == kSub) {
    const int want =
        j > 0 ? prev[i - L] : (l > 0 ? prev[(size_t)(k - 1) * L + l - 1] : first);
    if (lim == 0 || sync[i] == want) {
      exits[i] = prev[i];
      return;
    }
    count_walker(walked);
    s = want;
  } else {
    // warmup over the W4 words before the sub-lane's first word
    s = entries[i];
    const int off = j == 0 ? offsets[l] : 0;
    const int src = j == 0 ? (l == 0 ? L - 1 : l - 1) : l;
    const int w0 = (j == 0 ? T4 : j * G * 8) - W4;
    int unused = 0;
    for (int tw = 0; tw < W4; ++tw) {
      const uint32_t w = (uint32_t)tiles[(size_t)(w0 + tw) * L + src];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (tw * 4 + b >= off)
          s = t.step(s, (w >> (8 * b)) & 255, unused) >> 5;
      }
    }
  }
  sync[i] = s;
  int cnt = 0, last = -1;
  s = walk<MODE>(t, tiles, L, l, j * G, G, lim, s, cnt, last, flagw, firstw);
  counts[i] = cnt;
  exits[i] = s;
  if (MODE == kMatch) aux[i] = last;
}

// The row pitch of a launch's table: pitch_of in shared memory (width 2
// or 4), nseg in global memory.
int row_pitch(int nseg, int width) {
  return width ? pitch_of(nseg, width) : nseg;
}

// Dynamic shared memory of a block: the table of `width`-byte values in
// the shared-memory instance (width 0: global memory, no table there), and
// the byte map (not K3's or the reset mode's) in both
// (count_scan.lane_smem_bytes).
template <int MODE>
size_t smem_bytes(int width, int S, int nseg) {
  return (width ? table_bytes(S, row_pitch(nseg, width), width) : 0) +
         (MODE == kFlag || MODE == kReset ? 0 : 256 * sizeof(int32_t));
}

// Resident warps an SM of blocks taking `smem` bytes, at the block size
// that keeps the most, for a kernel of at most 32 registers a thread (the
// launch bounds' cap): the occupancy calculator's rule, so the host can
// mirror it exactly (count_scan.lane_warps).  0 past kSmemLimit.
int lane_warps(size_t smem) {
  if (smem > kSmemLimit) return 0;
  const size_t unit = (smem + kSmemUnit - 1) / kSmemUnit * kSmemUnit;
  int best = 0;
  for (int th = kThreads; th <= kMaxThreads; th *= 2) {
    int b = kMaxThreadsPerSM / th;
    b = min(b, kMaxBlocksPerSM);
    b = min(b, (int)(kSmemPerSM / (unit + kBlockReserved)));
    best = max(best, b * th / 32);
  }
  return best;
}

// Whether a mode's [S, nseg] table of vbytes-byte values takes the
// shared-memory instance: by the rule where it keeps at least
// kMinSharedWarps warps an SM there (count_scan.table_fits), else as
// `place` asks.
template <int MODE>
bool use_shared(int place, int vbytes, int S, int nseg) {
  if (place != kByRule) return place == kShared;
  return lane_warps(smem_bytes<MODE>(vbytes, S, nseg)) >= kMinSharedWarps;
}

// Threads a block: the smallest power of two from kThreads to kMaxThreads
// whose blocks keep the most threads of an SM resident (a table that
// leaves room for 16 blocks of 128 keeps 128; one that leaves room for one
// block an SM gets kMaxThreads).  The kernel's shared-memory attribute
// must be set.  Returns 0 if the occupancy calculator fails or no block
// fits.
template <int MODE, int PASS, bool SMEM, typename V>
int block_threads(size_t smem, int* blocks) {
  int best = 0, most = 0;
  for (int th = kThreads; th <= kMaxThreads; th *= 2) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, lane_walk_kernel<MODE, PASS, SMEM, V>, th, smem) !=
        cudaSuccess)
      return 0;
    if (b * th > most) {
      most = b * th;
      best = th;
      if (blocks) *blocks = b;
    }
  }
  return best;
}

// Sets the kernel's shared memory; gives its bytes, its block size
// (threads) and resident blocks an SM (blocks, may be null).
template <int MODE, int PASS, bool SMEM, typename V>
cudaError_t configure(int S, int nseg, size_t* smem, int* threads,
                      int* blocks) {
  *smem = smem_bytes<MODE>(SMEM ? (int)sizeof(V) : 0, S, nseg);
  if (*smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      lane_walk_kernel<MODE, PASS, SMEM, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return e;
  *threads = block_threads<MODE, PASS, SMEM, V>(*smem, blocks);
  return *threads == 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <int MODE, int PASS, bool SMEM, typename V>
int launch(const V* packed, int S, int nseg, const int32_t* segmap,
           const int32_t* tiles, int T4, int L, int W4, int k,
           const int32_t* entries, const int32_t* offsets,
           const int32_t* limits, int first, const int32_t* prev,
           int32_t* counts, int32_t* exits, int32_t* sync, int32_t* flagw,
           int32_t* aux, int32_t* walked, void* stream) {
  size_t smem = 0;
  int threads = 0;
  cudaError_t e =
      configure<MODE, PASS, SMEM, V>(S, nseg, &smem, &threads, nullptr);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (PASS != kFirst) {
    e = cudaMemsetAsync(walked, 0, sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  const long long walkers = PASS == kLane ? L : (long long)k * L;
  const int blocks = (int)((walkers + threads - 1) / threads);
  const int pitch = row_pitch(nseg, SMEM ? (int)sizeof(V) : 0);
  lane_walk_kernel<MODE, PASS, SMEM, V><<<blocks, threads, smem, st>>>(
      packed, S, nseg, pitch, segmap, tiles, T4, L, W4, k, entries, offsets,
      limits, first, prev, counts, exits, sync, flagw, aux, walked);
  return (int)cudaGetLastError();
}

// A mode's launch of one pass in one instance.
template <int MODE, bool SMEM, typename V>
int launch_pass(int pass, const V* packed, int S, int nseg,
                const int32_t* segmap, const int32_t* tiles, int T4, int L,
                int W4, int k, const int32_t* entries,
                const int32_t* offsets, const int32_t* limits, int first,
                const int32_t* prev, int32_t* counts, int32_t* exits,
                int32_t* sync, int32_t* flagw, int32_t* aux,
                int32_t* walked, void* stream) {
#define CGX_LAUNCH(P)                                                        \
  return launch<MODE, P, SMEM, V>(packed, S, nseg, segmap, tiles, T4, L, W4, \
                                  k, entries, offsets, limits, first, prev,  \
                                  counts, exits, sync, flagw, aux, walked,   \
                                  stream)
  if (pass == kFirst) CGX_LAUNCH(kFirst);
  if (pass == kSub) CGX_LAUNCH(kSub);
  CGX_LAUNCH(kLane);
#undef CGX_LAUNCH
}

// A mode's launch: the table's values are 16-bit (vbytes 2, at most kMax16
// rows) or int32 (vbytes 4), and it takes the instance use_shared picks
// for `place`.
template <int MODE>
int launch_mode(int pass, int place, const void* packed, int vbytes, int S,
                int nseg,
                const int32_t* segmap, const int32_t* tiles, int T4, int L,
                int W4, int k, const int32_t* entries, const int32_t* offsets,
                const int32_t* limits, int first, const int32_t* prev,
                int32_t* counts, int32_t* exits, int32_t* sync,
                int32_t* flagw, int32_t* aux, int32_t* walked, void* stream) {
  if (S < 1 || nseg < 1 || (vbytes != 2 && vbytes != 4) ||
      (vbytes == 2 && S > kMax16) || place < kByRule || place > kShared)
    return (int)cudaErrorInvalidValue;
  const bool shared = use_shared<MODE>(place, vbytes, S, nseg);
#define CGX_PASS(SM, V)                                                      \
  return launch_pass<MODE, SM, V>(                                           \
      pass, static_cast<const V*>(packed), S, nseg, segmap, tiles, T4, L, W4, \
      k, entries, offsets, limits, first, prev, counts, exits, sync, flagw,   \
      aux, walked, stream)
  if (vbytes == 2) {
    if (shared) CGX_PASS(true, uint16_t);
    CGX_PASS(false, uint16_t);
  }
  if (shared) CGX_PASS(true, int32_t);
  CGX_PASS(false, int32_t);
#undef CGX_PASS
}

// Resident blocks per SM, and the threads of each, of a mode's pass 0 on a
// table of vbytes-byte values in the instance use_shared picks.
template <int MODE>
int occupancy(int vbytes, int S, int nseg, int* blocks, int* threads) {
  if (S < 1 || nseg < 1 || (vbytes != 2 && vbytes != 4) ||
      (vbytes == 2 && S > kMax16))
    return (int)cudaErrorInvalidValue;
  const bool shared = use_shared<MODE>(kByRule, vbytes, S, nseg);
  size_t smem = 0;
  *blocks = 0;
  cudaError_t e;
  if (vbytes == 2)
    e = shared ? configure<MODE, kFirst, true, uint16_t>(S, nseg, &smem,
                                                         threads, blocks)
               : configure<MODE, kFirst, false, uint16_t>(S, nseg, &smem,
                                                          threads, blocks);
  else
    e = shared ? configure<MODE, kFirst, true, int32_t>(S, nseg, &smem,
                                                        threads, blocks)
               : configure<MODE, kFirst, false, int32_t>(S, nseg, &smem,
                                                         threads, blocks);
  return (int)e;
}

}  // namespace

extern "C" {

// Every entry takes the packed [S, nseg] table with its value width
// vbytes: 2 (uint16 values, S <= kMax16) or 4 (int32), and the table's
// place: -1 by the rule, 0 global memory, 1 shared memory (an error where
// the table does not fit).

// K1: pass 0 (kFirst, with warmup) or a repair pass (kSub, kLane) of the
// count transducer over k sub-lanes a lane.  Repair passes read prev and
// write exits, and zero then count *walked.
int cgx_lane_count(int pass, int place, const void* packed, int vbytes,
                   int S, int nseg,
                   const int32_t* segmap, const int32_t* tiles, int T4, int L,
                   int W4, int k, const int32_t* entries,
                   const int32_t* offsets, const int32_t* limits, int first,
                   const int32_t* prev, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* walked, void* stream) {
  return launch_mode<kCount>(pass, place, packed, vbytes, S, nseg, segmap,
                             tiles, T4, L, W4, k, entries, offsets, limits,
                             first, prev, counts, exits, sync, nullptr,
                             nullptr, walked, stream);
}

// K2: as K1, also writing the flag and first-flag words.
int cgx_lane_span(int pass, int place, const void* packed, int vbytes,
                  int S, int nseg,
                  const int32_t* segmap, const int32_t* tiles, int T4, int L,
                  int W4, int k, const int32_t* entries, const int32_t* offsets,
                  const int32_t* limits, int first, const int32_t* prev,
                  int32_t* counts, int32_t* exits, int32_t* sync,
                  int32_t* flagw, int32_t* firstw, int32_t* walked,
                  void* stream) {
  return launch_mode<kSpan>(pass, place, packed, vbytes, S, nseg, segmap,
                            tiles, T4, L, W4, k, entries, offsets, limits,
                            first, prev, counts, exits, sync, flagw, firstw,
                            walked, stream);
}

// K3: as K2 over symbol tiles (no byte map), writing the flag words and
// summing interference.
int cgx_lane_flag(int pass, int place, const void* packed, int vbytes,
                  int S, int nseg,
                  const int32_t* tiles, int T4, int L, int W4, int k,
                  const int32_t* entries, const int32_t* offsets,
                  const int32_t* limits, int first, const int32_t* prev,
                  int32_t* counts, int32_t* exits, int32_t* sync,
                  int32_t* flagw, int32_t* walked, void* stream) {
  return launch_mode<kFlag>(pass, place, packed, vbytes, S, nseg, nullptr,
                            tiles, T4, L, W4, k, entries, offsets, limits,
                            first, prev, counts, exits, sync, flagw, nullptr,
                            walked, stream);
}

// K9: as K2, writing the match flag words and each sub-lane's last flag
// position (`last`, [k, L]).
int cgx_lane_match(int pass, int place, const void* packed, int vbytes,
                   int S, int nseg,
                   const int32_t* segmap, const int32_t* tiles, int T4, int L,
                   int W4, int k, const int32_t* entries,
                   const int32_t* offsets, const int32_t* limits, int first,
                   const int32_t* prev, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* flagw, int32_t* last,
                   int32_t* walked, void* stream) {
  return launch_mode<kMatch>(pass, place, packed, vbytes, S, nseg, segmap,
                             tiles, T4, L, W4, k, entries, offsets, limits,
                             first, prev, counts, exits, sync, flagw, last,
                             walked, stream);
}

// The reset scan: as K3 over bytes column << 3 | ctx << 1 | reset with
// the start states `starts` [4] in registers, the [S, nseg] table (nseg
// <= 32) in shared or global memory, writing the flag words and counting
// the resets that met a live state.
int cgx_lane_reset(int pass, int place, const void* packed, int vbytes,
                   int S, int nseg,
                   const int32_t* starts, const int32_t* tiles, int T4, int L,
                   int W4, int k, const int32_t* entries,
                   const int32_t* offsets, const int32_t* limits, int first,
                   const int32_t* prev, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* flagw, int32_t* walked,
                   void* stream) {
  if (nseg > 32) return (int)cudaErrorInvalidValue;
  return launch_mode<kReset>(pass, place, packed, vbytes, S, nseg, starts,
                             tiles, T4, L, W4, k, entries, offsets, limits,
                             first, prev, counts, exits, sync, flagw,
                             nullptr, walked, stream);
}

// Resident blocks per SM, and the threads of each, of a K1 (mode 0), K2
// (mode 1), K3 (mode 2), K9 (mode 3) or reset (mode 4) pass-0 launch on
// an [S, nseg] table of vbytes-byte values, in the instance (shared or
// global memory) that the table takes, from the occupancy calculator.
int cgx_lane_occupancy(int mode, int vbytes, int S, int nseg, int* blocks,
                       int* threads) {
  if (mode == kCount)
    return occupancy<kCount>(vbytes, S, nseg, blocks, threads);
  if (mode == kSpan) return occupancy<kSpan>(vbytes, S, nseg, blocks, threads);
  if (mode == kFlag) return occupancy<kFlag>(vbytes, S, nseg, blocks, threads);
  if (mode == kMatch)
    return occupancy<kMatch>(vbytes, S, nseg, blocks, threads);
  return occupancy<kReset>(vbytes, S, nseg, blocks, threads);
}

const char* cgx_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
