// K10: ordered stream compaction of a byte mask in one pass, with 0-4 int32
// payloads and the switches of the compaction profiling rig.
//
// Replaces the Pallas kernel tools/_compact_exp.py:make_kernel(R, npay,
// do_route, do_dma, skip_empty, cond_dma) (launched by compact_exp at :243).
// The TPU kernel walks its grid in order on one core: each step takes a
// CH = R*128-entry tile, routes the set entries to the front through a
// binary-weighted shift network, and carries the running offset and the
// partial output row to the next step in scratch memory.  Blocks on Hopper
// run in no order and nothing carries between them, so the carry becomes a
// single-pass chained scan with decoupled look-back (compact_common.cuh),
// in persistent blocks that keep device memory busy:
//   - about (SMs x resident blocks an SM) blocks; each takes tiles by
//     ticket (atomicAdd).  Warp 1 publishes a tile's count (flag 1) as
//     soon as the tile is counted, before the block waits on anything, and
//     only then takes the next ticket, so every tile a look-back waits on
//     belongs to a running block that will publish it: the spin cannot
//     deadlock;
//   - a ring of two tile buffers in shared memory, fed by bulk copies
//     (cp.async.bulk, completing on an mbarrier): as soon as a tile's count
//     is out, its successor's bytes are requested;
//   - one ranking pass a tile: thread i holds the tile's 16-byte chunks k*256
//     + i (conflict-free shared loads), their non-zero bits in registers,
//     and the K = CH/4096 chunk counts packed 4 to a 64-bit word in 16-bit
//     fields, so one block scan (a warp scan, the warp totals in shared
//     memory, one barrier) ranks every entry of the tile;
//   - the look-back and the store of a tile wait one iteration: a tile's
//     positions are staged by in-tile rank (the stage does not depend on
//     its offset), and warp 0 looks back for it only after the block has
//     counted and published its next tile, while the other warps stage
//     that one.  A look-back right after the count waits on predecessors
//     whose blocks are themselves looking back before they count the tile
//     they hold, a convoy that held the tile rate at the look-back's; one
//     iteration later those counts are out;
//   - the look-back reads the tiles of its own group of 32, then whole
//     groups (each tile also adds its count into its group's accumulator),
//     so it costs about two round trips however many tiles are in flight;
//   - a tile of more than kStage set entries looks back at once and stages
//     and stores kStage at a time; payload gathers for up to four entries
//     a thread are issued before their stores.
//   Two block barriers a sparse tile (the TPU-shaped port took 14).
// Switches (skip_empty and cond_dma are runtime arguments; the two timing
// ablations are template parameters, so the instantiation that gives valid
// results carries neither):
//   skip_empty  an empty tile that is not the last publishes its count and
//               does nothing else (no look-back, so later tiles look past
//               it);
//   cond_dma    a window's store loop runs over its live entries only;
//               otherwise it runs over the whole staged window (the TPU's
//               unconditional write), storing below the tile's own output
//               end, so the same entries land;
//   do_route=0  no in-tile ordering: each entry is staged at its own input
//               slot (mod kStage) (results invalid; timing only);
//   do_dma=0    no global stores but the count (results invalid).
// Contract (the rig's compact_exp): pos ascending for the first cnt slots,
// payloads routed alike; the wrapper pads pos past cnt with n.
//
// What bounds it on an H100: device-memory bytes, the mask once (n bytes)
// plus the live entries' payload reads and the output stores; the
// arithmetic is a few integer ops per entry.  Measured alternatives
// (PERF.md, PR 12): a look-back right after the count (0.33-0.42 ms at
// R = 128), one reading 64-256 predecessors a round trip (0.44-0.79).

#include "compact_common.cuh"

namespace {

using cgx::kFlagAgg;
using cgx::kFlagPrefix;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // entries of one 16-byte load a thread
constexpr int kStage = 1024;           // staged output entries per window
constexpr int kRing = 2;               // tile buffers

struct Pays {
  const int32_t* in[4];
  int32_t* out[4];
};

// field k of packed 16-bit counts
template <int NP>
__device__ __forceinline__ int field(const unsigned long long (&w)[NP],
                                     int k) {
  return (int)((w[k >> 2] >> (16 * (k & 3))) & 0xffffu);
}

// Stage the tile's entries of output ranks [w0, w0 + kStage) at rank - w0.
template <int K, bool kRoute>
__device__ __forceinline__ void stage_window(int32_t* stage,
                                             const unsigned (&bits)[K],
                                             const int (&rank)[K], int w0,
                                             int base, int tid) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unsigned m = bits[k];
    const int slot0 = (k * kThreads + tid) * 16;
    if (kRoute) {
      int r = rank[k] - w0;
      if (!m || r >= kStage || r + __popc(m) <= 0) continue;
      for (; m; m &= m - 1, ++r)
        if (r >= 0 && r < kStage) stage[r] = base + slot0 + __ffs(m) - 1;
    } else {
      for (; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        stage[(slot0 + j) & (kStage - 1)] = base + slot0 + j;
      }
    }
  }
}

// Store the staged window: wn entries to [off_w, off_w + wn); the loop runs
// over `span` slots.
template <bool kRoute>
__device__ __forceinline__ void store_window(const int32_t* stage, int wn,
                                             int span, int off_w, int n,
                                             const Pays& pays, int npay,
                                             int32_t* __restrict__ pos,
                                             int tid) {
  for (int i0 = 0; i0 < span; i0 += 4 * kThreads) {
    int p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads + tid;
      p[u] = i < wn ? stage[i] : -1;
    }
    int v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // without routing the stage holds stale slots: keep gathers in range
      const int g = kRoute ? p[u] : ((unsigned)p[u] < (unsigned)n ? p[u] : 0);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < npay && p[u] != -1) v[u][q] = __ldg(pays.in[q] + g);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (p[u] == -1) continue;
      const int i = off_w + i0 + u * kThreads + tid;
      pos[i] = p[u];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < npay) pays.out[q][i] = v[u][q];
    }
  }
}

// R = 128 (K = 4): 5 resident blocks an SM, which their shared memory
// allows; the larger tiles' shared memory allows at most 3 and 1
template <int K, bool kRoute, bool kDma>
__global__ void __launch_bounds__(kThreads, K == 4 ? 5 : 1)
compact_exp_kernel(const uint8_t* __restrict__ mask, int nc, Pays pays,
                   int npay, int out_len, int32_t* __restrict__ pos,
                   int skip_empty, int cond_dma,
                   unsigned long long* __restrict__ status,
                   unsigned long long* __restrict__ gacc,
                   unsigned* __restrict__ ticket, int32_t* __restrict__ cnt) {
  constexpr int CH = K * kChunk;  // tile entries, R * 128
  constexpr int NP = K / 4;       // packed count words
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* ring = smem;                                             // [2][CH]
  int32_t* stages = reinterpret_cast<int32_t*>(smem + kRing * CH);  // [2][kStage]
  __shared__ __align__(8) unsigned long long bar[kRing];
  __shared__ unsigned long long wtot[kWarps][NP];
  __shared__ int s_tile, s_next, s_excl;
  __shared__ volatile int s_pub;  // the tile whose count warp 1 published
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = nc * CH;

  // warp 0: tile tt's offset into s_excl, its inclusive prefix published
  auto look_back = [&](int tt, int ttot) {
    int excl = 0;
    if (tt > 0) {
      excl = cgx::lookback_grouped(status, gacc, tt, lane);
      if (lane == 0)
        cgx::st_relaxed(&status[tt], kFlagPrefix | (unsigned)(excl + ttot));
    }
    if (lane == 0) {
      s_excl = excl;
      if (tt == nc - 1) *cnt = excl + ttot;
    }
  };
  // all threads: the staged window of output ranks [w0, w0 + kStage) of a
  // tile with ttot entries at offset off
  auto store = [&](const int32_t* stage, int off, int ttot, int w0) {
    if (!kDma) return;
    const int wn = min(min(kStage, ttot - w0), out_len - off - w0);
    store_window<kRoute>(stage, wn, cond_dma ? wn : kStage, off + w0, n, pays,
                         npay, pos, tid);
  };

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) cgx::mbar_init(&bar[i], 1);
    cgx::fence_mbar_init();
    const int t = (int)atomicAdd(ticket, 1u);
    s_tile = t;
    s_pub = -1;
    if (t < nc) cgx::bulk_load(ring, mask + (size_t)t * CH, CH, &bar[0]);
  }
  __syncthreads();
  int t = s_tile;
  int buf = 0;
  unsigned parity = 0;  // bit i: the phase parity barrier i completes next
  // the tile whose positions wait in stages[ps] for its offset (-1: none),
  // and its count
  int tp = -1, ptot = 0, ps = 0;
  while (t < nc) {
    cgx::mbar_wait(&bar[buf], (parity >> buf) & 1u);
    parity ^= 1u << buf;

    // 1. count: this thread's chunks k*256 + tid, packed 16-bit counts
    const uint4* tile = reinterpret_cast<const uint4*>(ring + buf * CH);
    unsigned bits[K];
    unsigned long long own[NP], incl[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) own[q] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bits[k] = cgx::nz16(tile[k * kThreads + tid]);
      own[k >> 2] += (unsigned long long)__popc(bits[k]) << (16 * (k & 3));
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      incl[q] = cgx::warp_incl_scan64(own[q], lane);
      if (lane == 31) wtot[warp][q] = incl[q];
    }
    __syncthreads();  // (A) warp totals

    // 2. rank: the tile-wide exclusive rank of each chunk's first entry
    unsigned long long wex[NP], tot[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) wex[q] = tot[q] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const unsigned long long v = wtot[w][q];
        tot[q] += v;
        if (w < warp) wex[q] += v;
      }
    }
    int rank[K];
    int total = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rank[k] = total + field(wex, k) + field(incl, k) - field(own, k);
      total += field(tot, k);
    }
    const bool skip = skip_empty && total == 0 && t != nc - 1;

    // 3. warp 1 publishes the count, then takes the next ticket and
    //    requests its bytes
    if (tid == 32) {
      cgx::st_relaxed(&status[t], (t == 0 ? kFlagPrefix : kFlagAgg) |
                                      (unsigned)total);
      atomicAdd(&gacc[t >> 5], (1ull << 32) | (unsigned)total);
      s_pub = t;
      const int nt = (int)atomicAdd(ticket, 1u);
      s_next = nt;
      if (nt < nc)
        cgx::bulk_load(ring + (buf ^ 1) * CH, mask + (size_t)nt * CH, CH,
                       &bar[buf ^ 1]);
    }
    // 4. once the count is out, warp 0 looks back for the pending tile
    //    (its predecessors published their counts an iteration ago), while
    //    the others stage this tile's first window
    if (warp == 0 && tp >= 0) {
      if (lane == 0)
        while (s_pub != t) {
        }
      __syncwarp();
      look_back(tp, ptot);
    }
    int32_t* stage = stages + (ps ^ 1) * kStage;
    if (!skip) stage_window<K, kRoute>(stage, bits, rank, 0, t * CH, tid);
    __syncthreads();  // (B) stage, s_excl, s_next
    const int nt = s_next;

    // 5. the pending tile's store
    if (tp >= 0) store(stages + ps * kStage, s_excl, ptot, 0);
    tp = -1;
    // 6. a tile of at most kStage entries waits an iteration for its
    //    offset; a denser one looks back now and stores window by window
    if (!skip) {
      if (total <= kStage) {
        tp = t;
        ptot = total;
        ps ^= 1;
      } else {
        __syncthreads();  // s_excl is reused
        if (warp == 0) look_back(t, total);
        __syncthreads();
        const int off = s_excl;
        for (int w0 = 0;; w0 += kStage) {
          store(stage, off, total, w0);
          if (w0 + kStage >= total) break;
          __syncthreads();  // the stage is reused
          stage_window<K, kRoute>(stage, bits, rank, w0 + kStage, t * CH,
                                  tid);
          __syncthreads();
        }
      }
    }
    t = nt;
    buf ^= 1;
  }
  if (tp >= 0) {  // the block's last pending tile
    if (warp == 0) look_back(tp, ptot);
    __syncthreads();
    store(stages + ps * kStage, s_excl, ptot, 0);
  }
}

template <int K>
int launch(const uint8_t* mask, int nc, Pays pays, int npay, int out_len,
           int32_t* pos, int do_route, int do_dma, int skip_empty,
           int cond_dma, unsigned long long* status, int32_t* cnt,
           cudaStream_t st) {
  auto kernel = do_route ? (do_dma ? compact_exp_kernel<K, true, true>
                                   : compact_exp_kernel<K, true, false>)
                         : (do_dma ? compact_exp_kernel<K, false, true>
                                   : compact_exp_kernel<K, false, false>);
  const int smem = kRing * K * kChunk + 2 * kStage * (int)sizeof(int32_t);
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
  const int blocks = min(nc, sms * per_sm);
  kernel<<<blocks, kThreads, smem, st>>>(mask, nc, pays, npay, out_len, pos,
                                         skip_empty, cond_dma, status,
                                         status + nc + 1,
                                         (unsigned*)(status + nc), cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mask: nc * R * 128 bytes, 16-byte aligned; outputs hold out_len int32
// each; scratch holds nc + 1 + ceil(nc / 32) int64 (status words, the
// ticket counter, the group accumulators), cleared here; cnt one int32.
// R in {128, 256, 512}, npay in [0, 4].
int cgx_compact_exp(const uint8_t* mask, int nc, int R, int npay,
                    const int32_t* p0, const int32_t* p1, const int32_t* p2,
                    const int32_t* p3, int out_len, int32_t* pos, int32_t* o0,
                    int32_t* o1, int32_t* o2, int32_t* o3, int do_route,
                    int do_dma, int skip_empty, int cond_dma, void* scratch,
                    int32_t* cnt, void* stream) {
  if (nc < 1 || npay < 0 || npay > 4 ||
      (R != 128 && R != 256 && R != 512))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* status = (unsigned long long*)scratch;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)(nc + 1 + (nc + 31) / 32) * sizeof(unsigned long long),
      st);
  if (e != cudaSuccess) return (int)e;
  Pays pays = {{p0, p1, p2, p3}, {o0, o1, o2, o3}};
  const auto run = R == 128 ? launch<4> : R == 256 ? launch<8> : launch<16>;
  return run(mask, nc, pays, npay, out_len, pos, do_route, do_dma, skip_empty,
             cond_dma, status, cnt, st);
}

}  // extern "C"
