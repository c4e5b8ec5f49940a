// Window scan: B anchored DFA runs, each walking at most W bytes from its
// own start offset, in two forms: the flags form (cgx_window_flags) gives
// every position's match flag as a bitmap, the ends form (cgx_window_ends)
// only each run's last flag.
//
// Ports the JAX package's _window_scan_flags (ops/dfa_scan.py:626-674), a
// lax.scan loop with no Pallas kernel, and, as the ends form, its
// composition with the last flag that WindowScanner.ends_for_starts_device
// (:591-622) reads: find_first's reverse start search
// (meta/batch.py:_rev_start_flags) runs it over the anchored reverse DFA
// from the found match end, the general find_all forward over the
// anchored break-at-match DFA from every match start.  The packed table
// value is delta*32 + match.
//
// Semantics per lane b (positions in the scanned coordinates; with
// `reverse` the scan reads the corpus backwards, scanned position j being
// corpus byte n-1-j, so reverse scans need no flipped copy of the corpus):
//   start state = starts_tbl[context of the byte before start], SOT at 0
//   cut = min(edge[b], n) (n without edge), its context = SOT at n, else
//         that of byte cut
//   column t < W: the match flag of step t while start+t < cut; at
//                 start+t == cut the EOI flag eoi[state, cut context]
//   column W: the EOI flag when start+W == cut; alive = live and start+W < cut
// A lane stops at DEAD (absorbing, no flags), so the rest of its row is 0.
//
// Layouts: flagw [NW, B] int32, NW = ceil((W+1)/32), bit t%32 of word t/32
// = column t of the lane (lane-minor, so a warp's word stores coalesce),
// every word written; ends: ends[idx[b]] (ends[b] without idx) = start +
// the last flagged column, or -1; alive [B] int32 or uint8; eoi [S, 4]
// int32; starts_tbl [4] int32.
//
// What bounds it on an H100: each lane is one dependent chain of table
// lookups, one per byte (an int32 table in shared memory holds row
// offsets, so a step is a shared-memory load and a shift; a 16-bit table
// holds the packed values, a step then a load, a shift and a multiply by
// the row length; a table in global memory, read with __ldg, the same
// through L1 and L2); on the general find_all's round (54.8M
// lanes of about 3 bytes, sorted starts about 29 bytes apart) the lanes
// touch most 32-byte sectors of the corpus, so device-memory sectors, the
// starts and the ends bound it, and a lane's fixed work (its loads, its
// group's staging, its stores) costs more than its walk.  The design:
//   - blocks stay resident, load the table once (the shared-memory
//     instance, chosen on the host where the table fits beside the
//     byte map and the stage ring), and each warp takes groups of 32
//     consecutive lanes;
//   - a group whose bytes span at most kWarpStage (clustered starts, as
//     the general find_all's sorted ones) is staged in shared memory by
//     asynchronous 16-byte copies (cp.async) requested two groups ahead,
//     into a ring of kSlots slices per warp, and walks from there;
//   - any other group walks in aligned 16-byte chunks from device memory:
//     a lane loads the chunk that holds its next byte (with `reverse` it
//     walks the chunk downwards) with the context byte before its start,
//     and walks up to 16 steps from registers; from its second chunk on,
//     the next chunk's load is in flight while it walks the current one
//     (each chunk's bytes mapped to segments before the chain starts), so
//     a long walk pays about one round trip per 16 bytes, not one per
//     byte.  A chunk that would reach below 0 or past n is read byte by
//     byte: the corpus has no padding.
// Measured alternatives (PERF.md, PR 12): the chunked walk for every group
// (1.5-1.8 ms on the general round), 256-lane block groups staged with
// block barriers (0.98-1.06), warp groups prefetched through registers
// (0.96-1.01); this design 0.86.
//
// Table residency: the table, the byte map and every warp's stage ring
// share a block's shared memory, so a table of 35-180 KB as int32 left
// one block of 8 warps an SM.  The host packs a table of at most kMax16
// rows as 16-bit values (half the room), and the launch (plan_of;
// dfa_scan.window_plan mirrors it) takes:
//   - the stage slice from the starts' density (stage_for): 1024 bytes a
//     group where 32 starts n / B bytes apart and the window fit in it
//     (the general find_all's starts on a keyword list, about 6 bytes
//     apart), else 2048 (`\b\d+\b`'s, about 29 apart);
//   - blocks of kThreads = 1024 threads, one an SM (its registers allow
//     no second): 32 warps share one copy of the table, where blocks of
//     256 held 8 (`\b\d+\b`'s ends: 0.77 ms at 1024 threads, 0.82 at
//     512, 0.86 at 256, all 32 warps an SM);
//   - shared memory with int32 values (a 16-bit table widened as it is
//     copied: a step then needs no multiply), its rows skewed to an odd
//     number of words as the lane walk's (pitch_of), where the block's
//     table, byte map and stage rings fit at the density's slice or else
//     at 1024 bytes; else with 16-bit values where those fit;
//   - else global memory, whose stage rings leave the rest of the SM's
//     256 KB to L1, which caches the table (KW400's table: 1.68 ms at
//     1024-byte slices against 2.57 with four 256-thread blocks and
//     2048-byte slices, PERF.md, section 6).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSot = 0, kWord = 1, kNl = 2, kOther = 3;
constexpr int kThreads = 1024;     // a block, one an SM
// a warp group's staged corpus bytes: at most, and at least
constexpr int kWarpStage = 2048;
constexpr int kMinStage = 1024;
constexpr int kSlots = 3;         // staged groups a warp keeps
// the most dynamic shared memory a block takes (count_scan.SMEM_LIMIT)
constexpr int kSmemLimit = 232448;
// the most rows of a 16-bit table (count_scan.MAX16_ROWS)
constexpr int kMax16 = 2047;

__device__ __forceinline__ int context_of(int b) {
  const bool word = (b >= '0' && b <= '9') || (b >= 'A' && b <= 'Z') ||
                    b == '_' || (b >= 'a' && b <= 'z');
  return word ? kWord : (b == '\n' ? kNl : kOther);
}

// The 16 corpus bytes [cb, cb + 16) (data + cb is 16-byte aligned); bytes
// outside [0, n) read as 0 and are never walked.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ data,
                                            long long n, long long cb) {
  if (cb >= 0 && cb + 16 <= n)
    return __ldg(reinterpret_cast<const uint4*>(data + cb));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long j = cb + k;
    if (j >= 0 && j < n) w[k >> 2] |= (uint32_t)data[j] << ((k & 3) * 8);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the chunk's bytes in decreasing corpus order
__device__ __forceinline__ uint4 reversed(uint4 v) {
  return make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                    __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
}

__device__ __forceinline__ int byte_of(uint4 v, int k) {
  const uint32_t w = k < 8 ? (k < 4 ? v.x : v.y) : (k < 12 ? v.z : v.w);
  return (w >> ((k & 3) * 8)) & 0xff;
}

// The walk's table of element type E.  An int32 table in shared memory
// (SMEM) holds at entry so + seg the next state's row offset << 1 |
// match; a 16-bit one, and any table in global memory (read with __ldg),
// the packed value delta*32 + match.  Row offsets are state * pitch, so
// DEAD is 0.
template <bool SMEM, typename E>
struct WinTable {
  const E* tbl;
  int pitch;   // values a row

  // the row offset after segment sg from row offset so; m = the match bit
  __device__ __forceinline__ int step(int so, int sg, unsigned& m) const {
    if (SMEM && sizeof(E) == 4) {
      const int v = (int)tbl[so + sg];
      m = v & 1;
      return v >> 1;
    }
    const int v = SMEM ? (int)tbl[so + sg] : (int)__ldg(tbl + so + sg);
    m = v & 1;
    return (v >> 5) * pitch;
  }
};

struct Lanes {
  const void* packed;
  int vbytes;           // 2 (16-bit values) or 4 (int32)
  int nseg, ntbl;
  int pitch;            // the table's row pitch in the launch's instance
  int stage;            // a stage slice's bytes
  const int32_t* segmap;
  const int32_t* eoi;
  const int32_t* starts_tbl;
  const uint8_t* data;
  long long n;
  int reverse;
  const int32_t* starts;
  const int32_t* edge;  // null: n for every lane
  const int32_t* idx;   // ends form: null, or the slot of each lane's end
  int B, W;
  int32_t* flagw;       // flags form
  int32_t* ends;        // ends form
  void* alive;
  int alive_u8;
};

// One lane's walk and outputs.  With `stage` the lane's bytes come from the
// block's staged copy of corpus bytes [clo, clo + staged bytes); otherwise
// from device memory in 16-byte chunks.
template <bool kEnds, bool SMEM, typename E>
__device__ __forceinline__ void run_lane(const Lanes& a, int b, long long st0,
                                         const WinTable<SMEM, E>& tbl,
                                         const int32_t* seg,
                                         const int32_t* s_start,
                                         const uint8_t* stage, long long clo,
                                         long long align) {
  const uint8_t* __restrict__ data = a.data;
  const long long n = a.n;
  const bool rev = a.reverse != 0;
  auto cidx = [&](long long p) { return rev ? n - 1 - p : p; };
  auto chunk_of = [&](long long c) { return c - ((c + align) & 15); };
  auto chunk_p0 = [&](long long cb) { return rev ? n - 16 - cb : cb; };
  auto byte_at = [&](long long p) {  // clamped like the reference's gathers
    const long long c = cidx(p);
    return (int)data[c < 0 ? 0 : (c >= n ? n - 1 : c)];
  };
  const long long cut = a.edge ? min((long long)a.edge[b], n) : n;
  const long long rem = cut - st0;  // bytes from the start to the cut
  const int steps = rem <= 0 ? 0 : (int)min((long long)a.W, rem);
  const long long stop = st0 + steps;
  int last = -1;                  // ends form: last flagged column
  unsigned long long acc = 0;     // flags form: columns [wb, wb + 64)
  int wb = 0;
  // flags form: set column col, first storing the word below it if done
  auto put = [&](int col) {
    while (col - wb >= 32) {
      a.flagw[(size_t)(wb >> 5) * a.B + b] = (int32_t)(uint32_t)acc;
      acc >>= 32;
      wb += 32;
    }
    acc |= 1ull << (col - wb);
  };
  int so;                         // row offset of the state; DEAD is 0
  if (stage) {  // 32-bit offsets into the stage: step t reads i0 + d*t
    const int d = rev ? -1 : 1;
    const int i0 = (int)(cidx(st0) - clo);
    so = s_start[st0 == 0 ? kSot : context_of(stage[i0 - d])];
    for (int t = 0, i = i0; t < steps && so != 0; ++t, i += d) {
      unsigned m;
      so = tbl.step(so, seg[stage[i]], m);
      if (m) {
        if (kEnds)
          last = t;
        else
          put(t);
      }
    }
  } else {
    long long p = st0;
    long long cb = p < stop ? chunk_of(cidx(p)) : 0;
    uint4 cur = p < stop ? load_chunk(data, n, cb) : make_uint4(0, 0, 0, 0);
    so = s_start[st0 == 0 ? kSot : context_of(byte_at(st0 - 1))];
    bool first = true;
    while (p < stop && so != 0) {
      const long long p0 = chunk_p0(cb);
      const int lo = (int)(p - p0);
      const long long pend = min(stop, p0 + 16);
      const int hi = (int)(pend - p0);
      // the next chunk's load flies while this one is walked; a lane's
      // first chunk does not wait for it (most lanes die in it)
      const long long ncb = rev ? cb - 16 : cb + 16;
      const bool ahead = !first && pend < stop;
      uint4 nxt = ahead ? load_chunk(data, n, ncb) : make_uint4(0, 0, 0, 0);
      if (rev) cur = reversed(cur);
      unsigned cm = 0;
      if (first) {
        for (int j = lo; j < hi && so != 0; ++j) {
          unsigned m;
          so = tbl.step(so, seg[byte_of(cur, j)], m);
          cm |= m << j;
        }
      } else {
        int sg[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) sg[j] = seg[byte_of(cur, j)];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j >= lo && j < hi && so != 0) {
            unsigned m;
            so = tbl.step(so, sg[j], m);
            cm |= m << j;
          }
        }
      }
      if (kEnds) {
        if (cm) last = (int)(p0 - st0) + 31 - __clz(cm);
      } else {
        for (unsigned m = cm; m; m &= m - 1)
          put((int)(p0 - st0) + __ffs(m) - 1);
      }
      p = pend;
      cb = ncb;
      if (ahead) {
        cur = nxt;
      } else if (p < stop && so != 0) {
        cur = load_chunk(data, n, ncb);
      }
      first = false;
    }
  }
  // a live lane that walked up to the cut: the EOI flag at column cut -
  // start (also when the start is the cut)
  if (so != 0 && rem >= 0 && rem <= a.W &&
      a.eoi[(so / a.pitch) * 4 +
            (cut >= n ? kSot : context_of(byte_at(cut)))]) {
    if (kEnds)
      last = (int)rem;
    else
      put((int)rem);
  }
  const int alive = so != 0 && rem > a.W;
  if (kEnds) {
    a.ends[a.idx ? a.idx[b] : b] = last >= 0 ? (int32_t)(st0 + last) : -1;
  } else {
    const int NW = (a.W + 1 + 31) >> 5;
    for (int w = wb >> 5; w < NW; ++w) {
      a.flagw[(size_t)w * a.B + b] = (int32_t)(uint32_t)acc;
      acc >>= 32;
    }
  }
  if (a.alive_u8)
    static_cast<uint8_t*>(a.alive)[b] = (uint8_t)alive;
  else
    static_cast<int32_t*>(a.alive)[b] = alive;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Blocks stay resident; each warp takes groups of 32 consecutive lanes.  A
// group whose lanes' bytes (the context byte before the first start to W
// bytes past the last, in corpus order) span at most a stage slice
// (a.stage bytes) is staged in one of the warp's kSlots slices of shared
// memory by asynchronous 16-byte copies (cp.async), requested two groups
// ahead, so the copies' round trip overlaps two groups' walks; its lanes
// then walk from shared memory.  The general find_all's sorted starts,
// about 29 bytes apart, span about 1 KiB a group.  Other groups walk in
// chunks from device memory.  Warps share no barrier after the table is
// loaded, so a slow lane holds up its own warp only.  SMEM: the table in
// shared memory (else global memory; the byte map, the start states and
// the stage ring stay in shared memory).  V: the element type of the table
// in global memory; W: of its copy in shared memory (int32_t, in the row
// offset form, or a 16-bit table's own uint16_t).
template <bool kEnds, bool SMEM, typename V, typename W>
__global__ void __launch_bounds__(kThreads) window_kernel(Lanes a) {
  using E = typename std::conditional<SMEM, W, V>::type;
  extern __shared__ __align__(16) int32_t smem[];
  // the table's words in shared memory (rows of a.pitch values)
  const int nwords =
      SMEM ? (a.ntbl / a.nseg * a.pitch * (int)sizeof(W) + 3) / 4 : 0;
  int32_t* seg = smem + nwords;         // [256]
  __shared__ int32_t s_start[4];  // start row offsets by context
  const V* packed = static_cast<const V*>(a.packed);
  if (SMEM) {
    W* dst = reinterpret_cast<W*>(smem);
    for (int i = threadIdx.x; i < a.ntbl; i += kThreads) {
      const int r = i / a.nseg;
      const int v = (int)packed[i];    // delta*32 + match
      // int32: row offset*2 + match; 16-bit: the value
      dst[r * a.pitch + (i - r * a.nseg)] =
          sizeof(W) == 4 ? (W)(((v >> 5) * a.pitch) << 1 | (v & 1)) : (W)v;
    }
  }
  const WinTable<SMEM, E> tbl{
      SMEM ? reinterpret_cast<const E*>(smem)
           : reinterpret_cast<const E*>(packed),
      a.pitch};
  for (int i = threadIdx.x; i < 256; i += kThreads) seg[i] = a.segmap[i];
  if (threadIdx.x < 4)
    s_start[threadIdx.x] = a.starts_tbl[threadIdx.x] * a.pitch;
  __syncthreads();

  const long long n = a.n;
  const long long align =
      (long long)(reinterpret_cast<uintptr_t>(a.data) & 15);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = a.stage / 16;   // a slot's 16-byte chunks
  uint4* slots = reinterpret_cast<uint4*>(smem + ((nwords + 256 + 3) & ~3)) +
                 warp * kSlots * slice;
  const int stride = gridDim.x * kThreads;  // lanes between a warp's groups
  auto start_of = [&](int g) -> int {
    return g + lane < a.B ? a.starts[g + lane] : 0;
  };
  // Request the aligned corpus range [lo, hi) that the group from lane g
  // walks into slot s, or set lo = hi = 0 when it does not fit.
  auto request = [&](int g, int st, int s, int& lo, int& hi) {
    lo = hi = 0;
    if (g >= a.B) return;
    const bool has = g + lane < a.B;
    const int smin = __reduce_min_sync(0xffffffffu, has ? st : INT_MAX);
    const int smax = __reduce_max_sync(0xffffffffu, has ? st : -1);
    long long c0, c1;  // corpus bytes [c0, c1)
    if (a.reverse) {
      c0 = n - (long long)smax - a.W;
      c1 = n - (long long)smin + 1;
    } else {
      c0 = (long long)smin - 1;
      c1 = (long long)smax + a.W;
    }
    c0 = max(c0, 0LL);
    c1 = min(c1, n);
    const long long l = c0 - ((c0 + align) & 15);
    const long long h = c1 - ((c1 - 1 + align) & 15) + 15;
    if (smin < 0 || smax > n || c1 <= c0 || h - l > a.stage) return;
    lo = (int)l;
    hi = (int)h;
    uint4* dst = slots + s * slice;
    for (int k = lane; 16 * k < hi - lo; k += 32) {
      const long long cb = l + 16LL * k;
      if (cb >= 0 && cb + 16 <= n)
        cp_async16(dst + k, a.data + cb);
      else
        dst[k] = load_chunk(a.data, n, cb);  // an edge of the corpus
    }
  };

  int g = blockIdx.x * kThreads + warp * 32;
  int st0 = start_of(g), st1 = start_of(g + stride),
      st2 = start_of(g + 2 * stride);
  int lo0, hi0, lo1, hi1;
  request(g, st0, 0, lo0, hi0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  request(g + stride, st1, 1, lo1, hi1);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int s = 0; g < a.B; g += stride, s = s == kSlots - 1 ? 0 : s + 1) {
    // request the group two ahead; load the starts of the one after it
    const int st3 = start_of(g + 3 * stride);
    int lo2, hi2;
    request(g + 2 * stride, st2, s == 0 ? kSlots - 1 : s - 1, lo2, hi2);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 2;" ::: "memory");  // this group's
    __syncwarp();
    if (g + lane < a.B)
      run_lane<kEnds, SMEM, E>(
          a, g + lane, st0, tbl, seg, s_start,
          hi0 > lo0 ? reinterpret_cast<const uint8_t*>(slots + s * slice)
                    : nullptr,
          lo0, align);
    __syncwarp();  // the slot is requested again two groups on
    st0 = st1;
    st1 = st2;
    st2 = st3;
    lo0 = lo1;
    hi0 = hi1;
    lo1 = lo2;
    hi1 = hi2;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The row pitch (values a row) of an nseg-column table of `width`-byte
// values in shared memory, as the lane walk's (count_scan.lane_pitch):
// nseg, rounded up to an odd number of words a row where the row would
// span whole words; nseg in global memory (width 0).
int row_pitch(int nseg, int width) {
  if (!width) return nseg;
  if (width == 4) return nseg | 1;
  return (nseg & 1) || (nseg & 3) == 2 ? nseg : nseg + 2;
}

// Dynamic shared memory of a block: the [S, nseg] table of `width`-byte
// values (0: global memory, none) in rows of row_pitch, padded to words,
// the byte map, padding to 16 bytes and the warps' stage rings of
// `stage`-byte slices (dfa_scan.window_smem_bytes).
int smem_bytes(int width, int S, int nseg, int stage) {
  const int words = (S * row_pitch(nseg, width) * width + 3) / 4;
  return ((words + 256 + 3) & ~3) * (int)sizeof(int32_t) +
         (kThreads / 32) * kSlots * stage;
}

// The stage slice that B starts over n bytes want (dfa_scan.window_stage):
// kMinStage where 32 starts n / B bytes apart, the window and the chunks'
// alignment fit in it, else kWarpStage.
int stage_for(long long n, int B, int W) {
  const long long gap = B > 0 ? (n + B - 1) / B : n;
  return 32 * gap + W + 32 <= kMinStage ? kMinStage : kWarpStage;
}

struct Plan {
  int width;   // shared memory's value bytes (4 or 2), or 0: global memory
  int stage;   // a stage slice's bytes
};

// The launch over an [S, nseg] table of vbytes-byte values when its
// starts want `stage`-byte slices (dfa_scan.window_plan): shared memory
// where a block fits, at the wanted slice or else at kMinStage, with int32
// values, else with 16-bit ones; else global memory at the wanted slice.
// A caller that holds one place against the plain version names its
// `width` (0 global memory, 2 or 4 shared memory with values of that many
// bytes; -1 by the rule), and the plan keeps to it where it fits.
Plan plan_of(int S, int nseg, int vbytes, int stage, int width = -1) {
  if (width == 0) return {0, stage};
  for (int st = stage; st >= kMinStage; st /= 2) {
    for (int w = 4; w >= vbytes; w -= 2) {
      if ((width < 0 || w == width) &&
          smem_bytes(w, S, nseg, st) <= kSmemLimit)
        return {w, st};
    }
  }
  return {0, stage};
}

// Sets the kernel's shared memory for a launch at `stage`-byte slices;
// gives its bytes and the resident blocks an SM (the occupancy
// calculator).
template <bool kEnds, bool SMEM, typename V, typename W>
cudaError_t configure(Lanes& a, int stage, int* smem, int* per_sm) {
  auto kernel = window_kernel<kEnds, SMEM, V, W>;
  a.stage = stage;
  const int width = SMEM ? (int)sizeof(W) : 0;
  a.pitch = row_pitch(a.nseg, width);
  *smem = smem_bytes(width, a.ntbl / a.nseg, a.nseg, stage);
  if (*smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads,
                                                    *smem);
  if (e != cudaSuccess) return e;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Launches the kernel, or with `resident` only gives the warps an SM that
// it would keep resident.
template <bool kEnds, bool SMEM, typename V, typename W>
int launch_in(Lanes a, int stage, cudaStream_t st, int* resident) {
  int smem = 0, per_sm = 0;
  cudaError_t e = configure<kEnds, SMEM, V, W>(a, stage, &smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (resident) {
    *resident = per_sm * kThreads / 32;
    return 0;
  }
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const long long need = ((long long)a.B + kThreads - 1) / kThreads;
  const int blocks = (int)min(need, (long long)sms * per_sm);
  if (blocks == 0) return 0;
  window_kernel<kEnds, SMEM, V, W><<<blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The launch in the plan the table, the starts and `width` (plan_of) take
// (with `resident`: only the warps an SM it would keep resident); an error
// where a named width does not fit.
template <bool kEnds>
int launch(const Lanes& a, int width, cudaStream_t st,
           int* resident = nullptr) {
  if (a.nseg < 1 || a.ntbl < a.nseg || (a.vbytes != 2 && a.vbytes != 4) ||
      (a.vbytes == 2 && a.ntbl / a.nseg > kMax16) || width < -1 ||
      width > 4)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(a.ntbl / a.nseg, a.nseg, a.vbytes,
                         stage_for(a.n, a.B, a.W), width);
  if (width >= 0 && p.width != width) return (int)cudaErrorInvalidValue;
  if (a.vbytes == 2) {
    if (p.width == 0)
      return launch_in<kEnds, false, uint16_t, uint16_t>(a, p.stage, st,
                                                         resident);
    if (p.width == 2)
      return launch_in<kEnds, true, uint16_t, uint16_t>(a, p.stage, st,
                                                        resident);
    if (p.width == 4)
      return launch_in<kEnds, true, uint16_t, int32_t>(a, p.stage, st,
                                                       resident);
  } else {
    if (p.width == 0)
      return launch_in<kEnds, false, int32_t, int32_t>(a, p.stage, st,
                                                       resident);
    if (p.width == 4)
      return launch_in<kEnds, true, int32_t, int32_t>(a, p.stage, st,
                                                      resident);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// packed: the [S, nseg] table of vbytes-byte values (2: uint16, S <=
// kMax16; 4: int32)
int cgx_window_flags(const void* packed, int vbytes, int S, int nseg,
                     const int32_t* segmap, const int32_t* eoi,
                     const int32_t* starts_tbl, const uint8_t* data,
                     long long n, int reverse, const int32_t* starts,
                     const int32_t* edge, int B, int W, int32_t* flagw,
                     int32_t* alive, void* stream) {
  const Lanes a = {packed, vbytes, nseg, S * nseg, nseg, kWarpStage, segmap,
                   eoi, starts_tbl, data, n, reverse, starts, edge, nullptr,
                   B, W, flagw, nullptr, alive, 0};
  return launch<false>(a, -1, (cudaStream_t)stream);
}

// edge and idx may be null; alive is uint8 when alive_u8, else int32;
// width: the table's place (plan_of; -1 by the rule)
int cgx_window_ends(int width, const void* packed, int vbytes, int S,
                    int nseg,
                    const int32_t* segmap, const int32_t* eoi,
                    const int32_t* starts_tbl, const uint8_t* data,
                    long long n, int reverse, const int32_t* starts,
                    const int32_t* edge, const int32_t* idx, int B, int W,
                    int32_t* ends, void* alive, int alive_u8, void* stream) {
  const Lanes a = {packed, vbytes, nseg, S * nseg, nseg, kWarpStage, segmap,
                   eoi, starts_tbl, data, n, reverse, starts, edge, idx,
                   B, W, nullptr, ends, alive, alive_u8};
  return launch<true>(a, width, (cudaStream_t)stream);
}

// The plan of an ends-form launch over an [S, nseg] table of vbytes-byte
// values for B starts over n bytes at window W, at `place` (plan_of's
// width; -1 by the rule): the width of its values in shared memory (0:
// global memory), the stage slice's bytes and the resident warps an SM by
// the occupancy calculator (0 where a named place does not fit).
int cgx_window_plan(int place, int vbytes, int S, int nseg, long long n,
                    int B, int W, int* width, int* stage, int* resident) {
  if (S < 1 || nseg < 1 || (vbytes != 2 && vbytes != 4) ||
      (vbytes == 2 && S > kMax16) || place < -1 || place > 4)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(S, nseg, vbytes, stage_for(n, B, W), place);
  *width = p.width;
  *stage = p.stage;
  *resident = 0;
  if (place >= 0 && p.width != place) return 0;
  const Lanes a = {nullptr, vbytes, nseg, S * nseg, nseg, kWarpStage,
                   nullptr, nullptr, nullptr, nullptr, n, 0, nullptr,
                   nullptr, nullptr, B, W, nullptr, nullptr, nullptr, 1};
  return launch<true>(a, place, nullptr, resident);
}

}  // extern "C"
