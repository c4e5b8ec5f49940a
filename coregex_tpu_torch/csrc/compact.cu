// K4 and K8: ordered stream compaction of a byte mask with 0-4 int32
// payloads, in one pass over the mask.
//
// Replaces the Pallas kernels coregex_tpu/ops/compact2.py:_make_kernel(R,
// npay) (K4, launched by _compact_pay_call) and coregex_tpu/ops/compact.py:
// _compact_kernel / _kernel_init (K8, launched by _compact_call through
// compact_positions): one function, K8's with no payloads.  The TPU kernels
// walk their grid in order on one core, carrying the output offset from
// block to block and routing set entries through shift networks.  Blocks on
// Hopper run in no order, so the carry becomes a chained scan with
// decoupled look-back over tiles of kTile mask bytes:
//   1. persistent blocks (as many as fit on the card at once) take tiles in
//      order with an atomicAdd ticket;
//   2. a block keeps two tile buffers in shared memory and loads the next
//      ticket's tile with Hopper's 1-D bulk copy (cp.async.bulk, completed
//      on an mbarrier) while it works on the current one.  The bulk copy
//      takes 16-byte aligned addresses and lengths, so the mask's unaligned
//      head (< 16 bytes) and ragged tail are read with byte loads; no byte
//      outside [mask, mask + n) is read.  Tile t holds mask bytes from
//      t * kTile - lead on, where lead puts the first aligned byte at a
//      16-byte boundary of the buffer;
//   3. its eight worker warps count the tile with 16-byte shared loads,
//      keeping one 16-bit set-entry mask per thread and 4096-entry
//      sub-tile in registers, rank every set entry inside the tile (warp
//      shuffles, then each warp sums the warp totals itself) and publish
//      the tile's count;
//   4. meanwhile a ninth warp looks back for the tile's offset
//      (compact_common.cuh), from the moment the block holds the ticket,
//      so the look-back's round trips overlap the load and the count; it
//      publishes the tile's inclusive prefix once both are known (the two
//      writes to the status word are release-ordered maxima, so either
//      may land first);
//   5. positions are staged in order in shared memory, kStage at a time
//      (two buffers, one barrier a round), and stored coalesced at the
//      tile's offset, clipped at cap; each payload is read in output order
//      (thread i reads pay[stage[i]], ascending across a warp) and stored
//      beside them, so shared memory does not grow with the payloads.
// The last tile writes the count and the ok flag; a second launch pads
// [cnt, cap) with n and 0 using 16-byte stores, reading cnt on the device.
// Contract (compact2.py:compact_pay / _compact_pay_xla): pos ascending,
// payloads routed by the same permutation, entries past cap dropped, cnt
// the full total, ok = cnt <= cap; any n in [1, 2^31), any byte offset.
//
// What bounds it on an H100: device-memory bytes -- the mask once, the
// payloads at the set entries, and cap slots of each output (the fill
// included); the arithmetic is a few integer operations per mask byte.

#include "compact_common.cuh"

namespace {

using cgx::kFlagAgg;
using cgx::kFlagPrefix;
using cgx::nz16;
using cgx::warp_incl_scan;

constexpr int kWorkers = 256;               // threads that count, rank, store
constexpr int kWarps = kWorkers / 32;       // worker warps; warp kWarps looks back
constexpr int kThreads = kWorkers + 32;
constexpr int kTile = 32 * 1024;            // mask bytes per tile (2 blocks/SM)
constexpr int kSub = kWorkers * 16;         // sub-tile: one 16-byte group a worker
constexpr int kNSub = kTile / kSub;         // sub-tiles per tile
constexpr int kStage = 4096;                // positions staged per store round
constexpr int kUnroll = 4;                  // entries a worker stores at once
constexpr int kSmem = 2 * kTile + 2 * kStage * 4;
constexpr int kFillThreads = 256;
static_assert(kNSub % 2 == 0, "sub-tile counts are scanned in pairs");

struct Pays {
  const int32_t* in[4];
  int32_t* out[4];
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a barrier of the worker warps only
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWorkers) : "memory");
}

// the status word's two writers (a tile's count, then its inclusive
// prefix) may land in either order; the larger flag wins
__device__ __forceinline__ void max_release(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("red.release.gpu.global.max.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stage the positions of tile ranks [w0, w0 + kStage) into st: this
// thread's set entries of sub-tile s have ranks rank[s] on, in order.
__device__ __forceinline__ void stage_round(const unsigned (&bits)[kNSub],
                                            const int (&rank)[kNSub], int tid,
                                            int64_t t0, int w0, int32_t* st) {
#pragma unroll
  for (int s = 0; s < kNSub; ++s) {
    int r = rank[s];
    const int c = __popc(bits[s]);
    if (c && r < w0 + kStage && r + c > w0) {
      const int p0 = (int)(t0 + (int64_t)(s * kWorkers + tid) * 16);
      for (unsigned m = bits[s]; m; m &= m - 1, ++r)
        if (r >= w0 && r < w0 + kStage) st[r - w0] = p0 + __ffs(m) - 1;
    }
  }
}

// Store the staged positions st[0, wn) at pos[o:] and each payload's
// entries at those positions beside them.  With payloads a thread starts
// all the loads of its kUnroll entries before their stores, so the
// gathers' round trips overlap; without, the plain copy loop is faster.
__device__ __forceinline__ void store_round(const int32_t* st, int wn,
                                            int tid, int o,
                                            int32_t* __restrict__ pos,
                                            const Pays& pays, int npay) {
  if (npay == 0) {
    int32_t* dst = pos + o;
#pragma unroll 4
    for (int i = tid; i < wn; i += kWorkers) dst[i] = st[i];
    return;
  }
  for (int i0 = tid; i0 < wn; i0 += kUnroll * kWorkers) {
    int p[kUnroll];
    int32_t v[4][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWorkers;
      p[u] = i < wn ? st[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < npay) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * kWorkers < wn) v[q][u] = __ldg(pays.in[q] + p[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWorkers;
      if (i < wn) {
        pos[o + i] = p[u];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < npay) pays.out[q][o + i] = v[q][u];
      }
    }
  }
}

// One block per resident slot; ntiles tiles taken by ticket.  head and body
// are _tile_plan's: mask[head, head + body) is 16-byte aligned, loaded in
// bulk; the bytes before and after it are loaded one by one.
__global__ void __launch_bounds__(kThreads, 2)
compact_kernel(const uint8_t* __restrict__ mask, int64_t n, int head,
               int64_t body, int ntiles, Pays pays, int npay, int cap,
               int32_t* __restrict__ pos, int32_t* __restrict__ scal,
               unsigned long long* __restrict__ status,
               unsigned* __restrict__ ticket) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* tiles = smem;                                          // [2][kTile]
  int32_t* stage = reinterpret_cast<int32_t*>(smem + 2 * kTile);  // [2][kStage]
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int s_tile[2], s_excl, s_tot;
  __shared__ int warp_tot[kNSub][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lead = (16 - head) & 15;
  const int64_t body_end = head + body;

  // thread 0: load tile t's aligned bytes into buffer b, arming bar[b]
  auto load_tile = [&](int t, int b) {
    const int64_t t0 = (int64_t)t * kTile - lead;
    const int64_t lo = max64(t0, head), hi = min64(t0 + kTile, body_end);
    if (hi > lo) {
      mbar_expect_tx(&bar[b], (unsigned)(hi - lo));
      bulk_load(tiles + b * kTile + (lo - t0), mask + lo, (unsigned)(hi - lo),
                &bar[b]);
    } else {
      mbar_arrive(&bar[b]);
    }
  };

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int t = (int)atomicAdd(ticket, 1u);
    s_tile[0] = t;
    if (t < ntiles) load_tile(t, 0);
  }
  __syncthreads();
  int t = s_tile[0], cur = 0;
  unsigned parity = 0;   // bit b: the phase bar[b]'s next wait completes
  while (t < ntiles) {
    if (tid == 0) {
      const int tn = (int)atomicAdd(ticket, 1u);
      s_tile[cur ^ 1] = tn;
      if (tn < ntiles) load_tile(tn, cur ^ 1);
    }
    const int64_t t0 = (int64_t)t * kTile - lead;   // mask index of buf[0]
    unsigned bits[kNSub];
    int rank[kNSub];
    if (warp == kWarps) {
      // the look-back warp: the tile's offset from its predecessors,
      // while the workers wait for the tile and count it
      const int excl = t == 0 ? 0 : cgx::lookback(status, t, lane);
      if (lane == 0) s_excl = excl;
    } else {
      mbar_wait(&bar[cur], (parity >> cur) & 1u);
      parity ^= 1u << cur;
      uint8_t* buf = tiles + cur * kTile;

      // the head's 16-byte group (tile 0) and the tail's (the last
      // tile), bytes outside [0, n) zeroed
      const bool first = t == 0 && head > 0;
      const bool last = t == ntiles - 1 && body_end < n;
      if (first || last) {
        if (tid < 16 ? first : tid < 32 && last) {
          const int a = (tid < 16 ? 0 : (int)(body_end - t0)) + (tid & 15);
          const int64_t i = t0 + a;
          buf[a] = i >= 0 && i < n ? mask[i] : 0;
        }
        workers_sync();
      }

      // count and rank inside the tile; group g = s * kWorkers + tid
      const int ng = (int)((min64(kTile, n - t0) + 15) >> 4);
#pragma unroll
      for (int s = 0; s < kNSub; ++s) {
        const int g = s * kWorkers + tid;
        bits[s] = g < ng ? nz16(reinterpret_cast<const uint4*>(buf)[g]) : 0u;
      }
#pragma unroll
      for (int s = 0; s < kNSub; s += 2) {
        // two counts a word: a warp's sum is at most 512, so no carry
        const int x = warp_incl_scan(
            __popc(bits[s]) | (__popc(bits[s + 1]) << 16), lane);
        rank[s] = x & 0xffff;
        rank[s + 1] = x >> 16;
        if (lane == 31) {
          warp_tot[s][warp] = rank[s];
          warp_tot[s + 1][warp] = rank[s + 1];
        }
      }
      workers_sync();
      // lane s: sub-tile s's total and this warp's offset inside it
      int sub = 0, before = 0;
      if (lane < kNSub) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int v = warp_tot[lane][w];
          sub += v;
          before += w < warp ? v : 0;
        }
      }
      const int sub_incl = warp_incl_scan(sub, lane);
      const int tot = __shfl_sync(0xffffffffu, sub_incl, 31);
      const int off = sub_incl - sub + before;
#pragma unroll
      for (int s = 0; s < kNSub; ++s)
        rank[s] += __shfl_sync(0xffffffffu, off, s) - __popc(bits[s]);
      if (tid == 0) {
        s_tot = tot;
        max_release(&status[t], (t == 0 ? kFlagPrefix : kFlagAgg) |
                                    (unsigned)tot);
      }
      if (tot > 0) stage_round(bits, rank, tid, t0, 0, stage);
    }
    __syncthreads();
    const int excl = s_excl, tot = s_tot;
    if (warp == kWarps) {
      if (lane == 0) {
        if (t > 0) max_release(&status[t], kFlagPrefix | (unsigned)(excl + tot));
        if (t == ntiles - 1) {
          scal[0] = excl + tot;
          scal[1] = excl + tot <= cap ? 1 : 0;
        }
      }
    } else {
      const int lim = min(tot, cap - excl);   // tile ranks that get a slot
      for (int w0 = 0, k = 0; w0 < lim; w0 += kStage, ++k) {
        int32_t* st = stage + (k & 1) * kStage;
        if (k > 0) {
          stage_round(bits, rank, tid, t0, w0, st);
          workers_sync();
        }
        store_round(st, min(kStage, lim - w0), tid, excl + w0, pos, pays,
                    npay);
      }
    }
    // the buffers are reused: order this tile's shared accesses before the
    // next bulk copy into them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    t = s_tile[cur ^ 1];
    cur ^= 1;
  }
}

// pos[cnt:cap] = n and out[k][cnt:cap] = 0, 16 bytes a store where a whole
// aligned int4 lies past cnt (the outputs are fresh allocations, 16-byte
// aligned)
__global__ void __launch_bounds__(kFillThreads)
fill_kernel(const int32_t* __restrict__ scal, int cap, int32_t n, Pays pays,
            int npay, int32_t* __restrict__ pos) {
  const int cnt = scal[0];
  if (cnt >= cap) return;
  const int nq = (int)(((int64_t)cap + 3) >> 2);
  const int step = gridDim.x * kFillThreads;
  for (int q = (cnt >> 2) + blockIdx.x * kFillThreads + threadIdx.x; q < nq;
       q += step) {
    const int64_t j = 4ll * q;
    if (j >= cnt && j + 4 <= cap) {
      reinterpret_cast<int4*>(pos)[q] = make_int4(n, n, n, n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < npay)
          reinterpret_cast<int4*>(pays.out[k])[q] = make_int4(0, 0, 0, 0);
    } else {
      for (int64_t e = j < cnt ? cnt : j; e < j + 4 && e < cap; ++e) {
        pos[e] = n;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < npay) pays.out[k][e] = 0;
      }
    }
  }
}

int g_grid[64];   // resident compact_kernel blocks on each device (0: unknown)

}  // namespace

extern "C" {

// The plan (head, body, ntiles) is ops/compact2.py:_tile_plan's for this
// mask's byte offset; ntiles must be the count of kTile tiles it gives.
// scratch holds ntiles + 1 int64 (status words, then the ticket), cleared
// here; scal holds [count, ok].  n in [1, 2^31), npay in [0, 4], cap >= 0.
int cgx_compact(const uint8_t* mask, int64_t n, int head, int64_t body,
                int ntiles, int npay, const int32_t* p0, const int32_t* p1,
                const int32_t* p2, const int32_t* p3, int cap, int32_t* pos,
                int32_t* o0, int32_t* o1, int32_t* o2, int32_t* o3,
                void* scratch, int32_t* scal, void* stream) {
  if (n < 1 || n >= (1ll << 31) || head < 0 || head > 15 || body < 0 ||
      (body & 15) || head + body > n ||
      ntiles != (((16 - head) & 15) + n + kTile - 1) / kTile || npay < 0 ||
      npay > 4 || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_grid[dev] == 0) {
    int sms, occ;
    e = cudaFuncSetAttribute(compact_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, compact_kernel,
                                                        kThreads, kSmem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    g_grid[dev] = occ * sms;
  }
  e = cudaMemsetAsync(scratch, 0,
                      (size_t)(ntiles + 1) * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  Pays pays = {{p0, p1, p2, p3}, {o0, o1, o2, o3}};
  unsigned long long* status = (unsigned long long*)scratch;
  compact_kernel<<<ntiles < g_grid[dev] ? ntiles : g_grid[dev], kThreads,
                   kSmem, st>>>(mask, n, head, body, ntiles, pays, npay, cap,
                                pos, scal, status, (unsigned*)(status + ntiles));
  e = cudaGetLastError();
  if (e != cudaSuccess || cap == 0) return (int)e;
  const int64_t want = ((int64_t)cap + 4 * kFillThreads - 1) /
                       (4 * kFillThreads);
  const int fill_blocks = (int)(want < 16 * g_grid[dev] ? want
                                                        : 16 * g_grid[dev]);
  fill_kernel<<<fill_blocks, kFillThreads, 0, st>>>(scal, cap, (int32_t)n,
                                                    pays, npay, pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
