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
// where it fits and each byte costs one or two shared-memory loads.  Every
// mode also has a global-memory instance, chosen on the host by the table's
// size (lane_smem): a table past shared memory (a list of hundreds of
// keywords: 1,000-4,000 states over 60-76 segments, 0.3-1.2 MB) is read
// with __ldg, through L1 and L2, while the byte map stays in shared memory.
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
// whole lanes) whose entry differs from their predecessor's exit.  Most
// tables of K1-K3 and K9 are small, so blocks stay resident by registers,
// not shared memory; a global-memory instance holds only the byte map
// there, so its blocks stay resident by registers too, and each byte's
// load is an L1 hit where the walk stays in a few hot rows, an L2 hit
// otherwise.  The reset mode's table may leave room for one block an SM
// (run_gap_x's 128 KiB): its launch takes the block size, 128 to 1024
// threads, that keeps the most walkers resident (block_threads).
//
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

constexpr int kThreads = 128;       // a block of K1-K3 and K9
constexpr int kMaxThreads = 1024;   // the reset mode's largest block
// the most dynamic shared memory a block takes (count_scan.SMEM_LIMIT)
constexpr size_t kSmemLimit = 232448;

// The walk's table: in shared memory (SMEM) or global memory.
template <int MODE, bool SMEM>
struct Table {
  const int32_t* tbl;
  const int32_t* seg;
  int nseg;
  int st0, st1, st2, st3;   // reset mode: the start state by context

  __device__ __forceinline__ int load(int i) const {
    return SMEM ? tbl[i] : __ldg(tbl + i);
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
      return load(s * nseg + (b >> 3));
    }
    return load(s * nseg + (MODE == kFlag ? b : seg[b]));
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

template <int MODE, int PASS, bool SMEM>
__global__ void __launch_bounds__(MODE == kReset ? kMaxThreads : kThreads)
lane_walk_kernel(
    const int32_t* __restrict__ packed, int S, int nseg,
    const int32_t* __restrict__ segmap, const int32_t* __restrict__ tiles,
    int T4, int L, int W4, int k, const int32_t* __restrict__ entries,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ limits,
    int first, const int32_t* __restrict__ prev, int32_t* __restrict__ counts,
    int32_t* __restrict__ exits, int32_t* __restrict__ sync,
    int32_t* __restrict__ flagw, int32_t* __restrict__ aux,
    int32_t* __restrict__ walked) {
  extern __shared__ int32_t smem[];
  const int ntbl = SMEM ? S * nseg : 0;   // table words in shared memory
  Table<MODE, SMEM> t{SMEM ? smem : packed, smem + ntbl, nseg, 0, 0, 0, 0};
  if (SMEM) {
    for (int i = threadIdx.x; i < ntbl; i += blockDim.x) smem[i] = packed[i];
  }
  if (MODE == kReset) {
    t.st0 = segmap[0];
    t.st1 = segmap[1];
    t.st2 = segmap[2];
    t.st3 = segmap[3];
  } else if (MODE != kFlag) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      smem[ntbl + i] = segmap[i];
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

// Dynamic shared memory of a block: the table in the shared-memory
// instance, and the byte map (not K3's or the reset mode's) in both.
template <int MODE, bool SMEM>
size_t smem_bytes(int S, int nseg) {
  const size_t tbl = SMEM ? (size_t)S * nseg : 0;
  return (tbl + (MODE == kFlag || MODE == kReset ? 0 : 256)) *
         sizeof(int32_t);
}

// Whether a mode's [S, nseg] table takes the shared-memory instance
// (count_scan.table_fits).
template <int MODE>
bool lane_smem(int S, int nseg) {
  return smem_bytes<MODE, true>(S, nseg) <= kSmemLimit;
}

// Threads a block: kThreads, or for the reset mode the smallest power of
// two from kThreads to kMaxThreads whose blocks keep the most threads of
// an SM resident (a table that leaves room for one block an SM gets
// kMaxThreads).  The kernel's shared-memory attribute must be set.
// Returns 0 if the occupancy calculator fails.
template <int MODE, int PASS, bool SMEM>
int block_threads(size_t smem, int* blocks) {
  int best = 0, most = 0;
  for (int th = kThreads; th <= (MODE == kReset ? kMaxThreads : kThreads);
       th *= 2) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, lane_walk_kernel<MODE, PASS, SMEM>, th, smem) != cudaSuccess)
      return 0;
    if (b * th > most) {
      most = b * th;
      best = th;
      if (blocks) *blocks = b;
    }
  }
  return best;
}

template <int MODE, int PASS, bool SMEM>
int launch(const int32_t* packed, int S, int nseg, const int32_t* segmap,
           const int32_t* tiles, int T4, int L, int W4, int k,
           const int32_t* entries, const int32_t* offsets,
           const int32_t* limits, int first, const int32_t* prev,
           int32_t* counts, int32_t* exits, int32_t* sync, int32_t* flagw,
           int32_t* aux, int32_t* walked, void* stream) {
  const size_t smem = smem_bytes<MODE, SMEM>(S, nseg);
  auto kernel = lane_walk_kernel<MODE, PASS, SMEM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = block_threads<MODE, PASS, SMEM>(smem, nullptr);
  if (threads == 0) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  if (PASS != kFirst) {
    e = cudaMemsetAsync(walked, 0, sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  const long long walkers = PASS == kLane ? L : (long long)k * L;
  const int blocks = (int)((walkers + threads - 1) / threads);
  kernel<<<blocks, threads, smem, st>>>(
      packed, S, nseg, segmap, tiles, T4, L, W4, k, entries, offsets, limits,
      first, prev, counts, exits, sync, flagw, aux, walked);
  return (int)cudaGetLastError();
}

// K1-K3, K9 and the reset mode dispatch over the pass
template <int MODE, bool SMEM>
int launch_split(int pass, const int32_t* packed, int S, int nseg,
                 const int32_t* segmap, const int32_t* tiles, int T4, int L,
                 int W4, int k, const int32_t* entries, const int32_t* offsets,
                 const int32_t* limits, int first, const int32_t* prev,
                 int32_t* counts, int32_t* exits, int32_t* sync,
                 int32_t* flagw, int32_t* aux, int32_t* walked, void* stream) {
#define CGX_LAUNCH(P)                                                        \
  return launch<MODE, P, SMEM>(packed, S, nseg, segmap, tiles, T4, L, W4, k,  \
                               entries, offsets, limits, first, prev, counts, \
                               exits, sync, flagw, aux, walked, stream)
  if (pass == kFirst) CGX_LAUNCH(kFirst);
  if (pass == kSub) CGX_LAUNCH(kSub);
  CGX_LAUNCH(kLane);
#undef CGX_LAUNCH
}

// A mode's launch in the instance its table takes.
template <int MODE>
int launch_mode(int pass, const int32_t* packed, int S, int nseg,
                const int32_t* segmap, const int32_t* tiles, int T4, int L,
                int W4, int k, const int32_t* entries, const int32_t* offsets,
                const int32_t* limits, int first, const int32_t* prev,
                int32_t* counts, int32_t* exits, int32_t* sync,
                int32_t* flagw, int32_t* aux, int32_t* walked, void* stream) {
  if (S < 1 || nseg < 1) return (int)cudaErrorInvalidValue;
#define CGX_SPLIT(SM)                                                         \
  return launch_split<MODE, SM>(pass, packed, S, nseg, segmap, tiles, T4, L, \
                                W4, k, entries, offsets, limits, first, prev, \
                                counts, exits, sync, flagw, aux, walked,      \
                                stream)
  if (lane_smem<MODE>(S, nseg)) CGX_SPLIT(true);
  CGX_SPLIT(false);
#undef CGX_SPLIT
}

template <int MODE, bool SMEM>
int occupancy_of(int S, int nseg, int* blocks, int* threads) {
  const size_t smem = smem_bytes<MODE, SMEM>(S, nseg);
  cudaError_t e = cudaFuncSetAttribute(
      lane_walk_kernel<MODE, kFirst, SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = 0;
  *threads = block_threads<MODE, kFirst, SMEM>(smem, blocks);
  return *threads == 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// Resident blocks an SM, and the threads of each, of a mode's pass 0 in
// the instance its table takes.
template <int MODE>
int occupancy(int S, int nseg, int* blocks, int* threads) {
  if (lane_smem<MODE>(S, nseg))
    return occupancy_of<MODE, true>(S, nseg, blocks, threads);
  return occupancy_of<MODE, false>(S, nseg, blocks, threads);
}

}  // namespace

extern "C" {

// K1: pass 0 (kFirst, with warmup) or a repair pass (kSub, kLane) of the
// count transducer over k sub-lanes a lane.  Repair passes read prev and
// write exits, and zero then count *walked.
int cgx_lane_count(int pass, const int32_t* packed, int S, int nseg,
                   const int32_t* segmap, const int32_t* tiles, int T4, int L,
                   int W4, int k, const int32_t* entries,
                   const int32_t* offsets, const int32_t* limits, int first,
                   const int32_t* prev, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* walked, void* stream) {
  return launch_mode<kCount>(pass, packed, S, nseg, segmap, tiles, T4, L,
                             W4, k, entries, offsets, limits, first, prev,
                             counts, exits, sync, nullptr, nullptr, walked,
                             stream);
}

// K2: as K1, also writing the flag and first-flag words.
int cgx_lane_span(int pass, const int32_t* packed, int S, int nseg,
                  const int32_t* segmap, const int32_t* tiles, int T4, int L,
                  int W4, int k, const int32_t* entries, const int32_t* offsets,
                  const int32_t* limits, int first, const int32_t* prev,
                  int32_t* counts, int32_t* exits, int32_t* sync,
                  int32_t* flagw, int32_t* firstw, int32_t* walked,
                  void* stream) {
  return launch_mode<kSpan>(pass, packed, S, nseg, segmap, tiles, T4, L, W4,
                            k, entries, offsets, limits, first, prev, counts,
                            exits, sync, flagw, firstw, walked, stream);
}

// K3: as K2 over symbol tiles (no byte map), writing the flag words and
// summing interference.
int cgx_lane_flag(int pass, const int32_t* packed, int S, int nseg,
                  const int32_t* tiles, int T4, int L, int W4, int k,
                  const int32_t* entries, const int32_t* offsets,
                  const int32_t* limits, int first, const int32_t* prev,
                  int32_t* counts, int32_t* exits, int32_t* sync,
                  int32_t* flagw, int32_t* walked, void* stream) {
  return launch_mode<kFlag>(pass, packed, S, nseg, nullptr, tiles, T4, L,
                            W4, k, entries, offsets, limits, first, prev,
                            counts, exits, sync, flagw, nullptr, walked,
                            stream);
}

// K9: as K2, writing the match flag words and each sub-lane's last flag
// position (`last`, [k, L]).
int cgx_lane_match(int pass, const int32_t* packed, int S, int nseg,
                   const int32_t* segmap, const int32_t* tiles, int T4, int L,
                   int W4, int k, const int32_t* entries,
                   const int32_t* offsets, const int32_t* limits, int first,
                   const int32_t* prev, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* flagw, int32_t* last,
                   int32_t* walked, void* stream) {
  return launch_mode<kMatch>(pass, packed, S, nseg, segmap, tiles, T4, L,
                             W4, k, entries, offsets, limits, first, prev,
                             counts, exits, sync, flagw, last, walked,
                             stream);
}

// The reset scan: as K3 over bytes column << 3 | ctx << 1 | reset with
// the start states `starts` [4] in registers, the [S, nseg] table (nseg
// <= 32) in shared memory or, past kSmemLimit, global memory, writing the
// flag words and counting the resets that met a live state.
int cgx_lane_reset(int pass, const int32_t* packed, int S, int nseg,
                   const int32_t* starts, const int32_t* tiles, int T4, int L,
                   int W4, int k, const int32_t* entries,
                   const int32_t* offsets, const int32_t* limits, int first,
                   const int32_t* prev, int32_t* counts, int32_t* exits,
                   int32_t* sync, int32_t* flagw, int32_t* walked,
                   void* stream) {
  if (nseg > 32) return (int)cudaErrorInvalidValue;
  return launch_mode<kReset>(pass, packed, S, nseg, starts, tiles, T4, L,
                             W4, k, entries, offsets, limits, first, prev,
                             counts, exits, sync, flagw, nullptr, walked,
                             stream);
}

// Resident blocks per SM, and the threads of each, of a K1 (mode 0), K2
// (mode 1), K3 (mode 2), K9 (mode 3) or reset (mode 4) pass-0 launch on
// an [S, nseg] table, in the instance (shared or global memory) that the
// table takes.
int cgx_lane_occupancy(int mode, int S, int nseg, int* blocks,
                       int* threads) {
  if (mode == kCount) return occupancy<kCount>(S, nseg, blocks, threads);
  if (mode == kSpan) return occupancy<kSpan>(S, nseg, blocks, threads);
  if (mode == kFlag) return occupancy<kFlag>(S, nseg, blocks, threads);
  if (mode == kMatch) return occupancy<kMatch>(S, nseg, blocks, threads);
  return occupancy<kReset>(S, nseg, blocks, threads);
}

const char* cgx_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
