// Device helpers of the ordered compactions: csrc/compact.cu (K4 and K8)
// and csrc/compact_exp.cu (K10, the compaction rig's kernel), and K10's
// bulk copies into shared memory with their mbarriers.
//
// Both find a tile's output offset by a chained scan with decoupled
// look-back: each tile publishes its set-entry count (flag 1) in a 64-bit
// status word, then one warp sums its predecessors' words back to the
// first that holds an inclusive prefix (flag 2), and publishes its own
// inclusive prefix.  Flag and value share the word, so a reader never sees
// a flag without its value.  Tiles are taken in ticket order, so every
// tile a look-back waits on belongs to a block that already runs.  K4 and
// K8 read 32 predecessors a round (lookback, st.release / ld.acquire); K10
// also keeps an accumulator per group of 32 tiles and reads whole groups
// (lookback_grouped, relaxed accesses).
//
// _build.py hashes this header with the sources, so an edit rebuilds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cgx {

constexpr unsigned long long kFlagAgg = 1ull << 32;     // the tile's count
constexpr unsigned long long kFlagPrefix = 2ull << 32;  // its inclusive prefix

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// bit t set iff byte t of w is non-zero
__device__ __forceinline__ unsigned nz4(unsigned w) {
  const unsigned v = __vcmpne4(w, 0u);
  return ((v >> 7) & 1u) | ((v >> 14) & 2u) | ((v >> 21) & 4u) |
         ((v >> 28) & 8u);
}

// bit t set iff byte t of the 16 is non-zero
__device__ __forceinline__ unsigned nz16(uint4 v) {
  return nz4(v.x) | (nz4(v.y) << 4) | (nz4(v.z) << 8) | (nz4(v.w) << 12);
}

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ unsigned long long warp_incl_scan64(
    unsigned long long x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// -- compact_exp.cu's look-back: relaxed status words, 256 a round trip ---
//
// A status word carries its flag and value in one 64-bit access, so a
// reader needs no ordering with other memory: relaxed (strong) loads and
// stores suffice, and a publish does not wait for the block's earlier
// output stores as a release does.

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One look-back round over 32 entries, one a lane: state 2 = an inclusive
// prefix (val), 1 = a count to add (val), 0 = not yet published.  Returns
// true when the sum is known: *sum gets the values of the lanes up to the
// nearest prefix (or of all lanes, *done false, when none holds one).
__device__ __forceinline__ bool lookback_round(int state, int val, int lane,
                                               int* sum, bool* done) {
  const unsigned pm = __ballot_sync(0xffffffffu, state == 2);
  const int k = pm ? __ffs(pm) - 1 : 31;  // lanes 0..k count
  const unsigned upto = k == 31 ? 0xffffffffu : (2u << k) - 1;
  if (__ballot_sync(0xffffffffu, state == 0) & upto) return false;
  *sum = __reduce_add_sync(0xffffffffu, lane <= k ? val : 0);
  *done = pm != 0;
  return true;
}

// The exclusive prefix of tile b > 0 from tile status words and group
// accumulators: gacc[g] holds the number of group g's 32 tiles that have
// published their count (high word) and the sum of those counts (low
// word), each tile adding (1 << 32) + count once.  First the tiles of b's
// own group before it, one a lane, then whole groups before that, 32 a
// round trip (1024 tiles), each read as the inclusive prefix of its last
// tile or, once all 32 tiles are in, its sum.  So a look-back costs about
// two round trips however many tiles are in flight, where a tile-by-tile
// walk pays one round trip per 32 tiles not yet resolved.  It waits only
// on entries up to the nearest prefix, backing off with __nanosleep so
// that spinning warps leave the SM's memory pipe to the blocks that work.
// Called by one whole warp; every lane returns it.
__device__ __forceinline__ int lookback_grouped(
    const unsigned long long* status, const unsigned long long* gacc, int b,
    int lane) {
  unsigned sleep = 32;
  auto back_off = [&] {
    __nanosleep(sleep);
    sleep = min(sleep * 2, 256u);
  };
  int excl = 0, sum;
  bool done;
  const int base = b & ~31;
  if (b > base) {  // the own group: lane l reads tile b - 1 - l
    const int idx = b - 1 - lane;
    for (;;) {
      const unsigned long long v = idx >= base ? ld_relaxed(&status[idx])
                                               : kFlagAgg;
      if (lookback_round((int)(v >> 32), (int)(unsigned)v, lane, &sum,
                         &done))
        break;
      back_off();
    }
    if (done) return sum;
    excl = sum;
  }
  for (int gj = (base >> 5) - 1;; gj -= 32) {  // lane l reads group gj - l
    const int g = gj - lane;
    for (;;) {
      int state = 2, val = 0;
      if (g >= 0) {
        const unsigned long long vt = ld_relaxed(&status[32 * g + 31]);
        const unsigned long long va = ld_relaxed(&gacc[g]);
        if ((vt >> 32) == 2) {
          val = (int)(unsigned)vt;
        } else if ((va >> 32) == 32) {
          state = 1;
          val = (int)(unsigned)va;
        } else {
          state = 0;
        }
      }
      if (lookback_round(state, val, lane, &sum, &done)) break;
      back_off();
    }
    if (done) return excl + sum;
    excl += sum;
  }
}

// -- bulk copies into shared memory (compact_exp.cu's tile ring) ----------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// one thread, then a fence_mbar_init and a block barrier before any use
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: a bulk copy of `bytes` (a multiple of 16, below 2^20) from
// global src to shared dst, both 16-byte aligned; it completes the
// barrier's current phase (count 1) when the bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// The exclusive prefix of tile b > 0: called by one whole warp after tile
// b published its count; every lane returns it.  Lane l reads predecessor
// j - l, so lane 0 holds the nearest; the warp spins until all 32 have
// published, then stops at the nearest inclusive prefix among them.
__device__ __forceinline__ int lookback(const unsigned long long* status,
                                        int b, int lane) {
  int excl = 0;
  for (int j = b - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long v;
    do {
      v = idx >= 0 ? ld_acquire(&status[idx]) : kFlagPrefix;
    } while (__any_sync(0xffffffffu, (v >> 32) == 0));
    const unsigned pm = __ballot_sync(0xffffffffu, (v >> 32) == 2);
    const int val = (int)(unsigned)(v & 0xffffffffu);
    if (pm) {
      const int k = __ffs(pm) - 1;
      return excl + __reduce_add_sync(0xffffffffu, lane <= k ? val : 0);
    }
    excl += __reduce_add_sync(0xffffffffu, val);
  }
}

}  // namespace cgx
