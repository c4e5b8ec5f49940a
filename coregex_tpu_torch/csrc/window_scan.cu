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
// lookups, one per byte (the table holds row offsets, so a step is a
// shared-memory load and a shift; a table past shared memory, a list of
// hundreds of keywords, is read from global memory with __ldg, a step
// then a load through L1 and L2, a shift and a multiply by the row
// length); on the general find_all's round (54.8M
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

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSot = 0, kWord = 1, kNl = 2, kOther = 3;
constexpr int kThreads = 256;
constexpr int kWarpStage = 2048;  // a warp group's staged corpus bytes
constexpr int kSlots = 3;         // staged groups a warp keeps
// the most dynamic shared memory a block takes (count_scan.SMEM_LIMIT)
constexpr int kSmemLimit = 232448;

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

// The walk's table.  In shared memory (SMEM) entry so + seg holds the
// next state's row offset << 1 | match; in global memory it is the packed
// value delta*32 + match, read with __ldg.  Row offsets are state * nseg,
// so DEAD is 0.
template <bool SMEM>
struct WinTable {
  const int32_t* tbl;
  int nseg;

  // the row offset after segment sg from row offset so; m = the match bit
  __device__ __forceinline__ int step(int so, int sg, unsigned& m) const {
    if (SMEM) {
      const int v = tbl[so + sg];
      m = v & 1;
      return v >> 1;
    }
    const int v = __ldg(tbl + so + sg);
    m = v & 1;
    return (v >> 5) * nseg;
  }
};

struct Lanes {
  const int32_t* packed;
  int nseg, ntbl;
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
template <bool kEnds, bool SMEM>
__device__ __forceinline__ void run_lane(const Lanes& a, int b, long long st0,
                                         const WinTable<SMEM>& tbl,
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
      a.eoi[(so / a.nseg) * 4 +
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
// bytes past the last, in corpus order) span at most kWarpStage bytes is
// staged in one of the warp's kSlots slices of shared memory by
// asynchronous 16-byte copies (cp.async), requested two groups ahead, so
// the copies' round trip overlaps two groups' walks; its lanes then walk
// from shared memory.  The general find_all's sorted starts, about 29
// bytes apart, span about 1 KiB a group.  Other groups walk in chunks from
// device memory.  Warps share no barrier after the table is loaded, so a
// slow lane holds up its own warp only.  SMEM: the table in shared memory
// (else global memory; the byte map, the start states and the stage ring
// stay in shared memory).
template <bool kEnds, bool SMEM>
__global__ void __launch_bounds__(kThreads) window_kernel(Lanes a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int ntbl = SMEM ? a.ntbl : 0;   // table words in shared memory
  int32_t* seg = smem + ntbl;           // [256]
  __shared__ int32_t s_start[4];  // start row offsets by context
  for (int i = threadIdx.x; i < ntbl; i += kThreads) {
    const int v = a.packed[i];    // delta*32 + match
    smem[i] = ((v >> 5) * a.nseg) << 1 | (v & 1);  // row offset*2 + match
  }
  const WinTable<SMEM> tbl{SMEM ? smem : a.packed, a.nseg};
  for (int i = threadIdx.x; i < 256; i += kThreads) seg[i] = a.segmap[i];
  if (threadIdx.x < 4)
    s_start[threadIdx.x] = a.starts_tbl[threadIdx.x] * a.nseg;
  __syncthreads();

  const long long n = a.n;
  const long long align =
      (long long)(reinterpret_cast<uintptr_t>(a.data) & 15);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* slots = reinterpret_cast<uint4*>(smem + ((ntbl + 256 + 3) & ~3)) +
                 warp * kSlots * (kWarpStage / 16);
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
    if (smin < 0 || smax > n || c1 <= c0 || h - l > kWarpStage) return;
    lo = (int)l;
    hi = (int)h;
    uint4* dst = slots + s * (kWarpStage / 16);
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
      run_lane<kEnds, SMEM>(a, g + lane, st0, tbl, seg, s_start,
                      hi0 > lo0 ? reinterpret_cast<const uint8_t*>(
                                      slots + s * (kWarpStage / 16))
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

// Dynamic shared memory of a block: the table (SMEM), the byte map and
// the warps' stage rings.
int smem_bytes(bool smem, int ntbl) {
  return (((smem ? ntbl : 0) + 256 + 3) & ~3) * (int)sizeof(int32_t) +
         (kThreads / 32) * kSlots * kWarpStage;
}

template <bool kEnds, bool SMEM>
int launch_in(const Lanes& a, cudaStream_t st) {
  auto kernel = window_kernel<kEnds, SMEM>;
  const int smem = smem_bytes(SMEM, a.ntbl);
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
  const long long need = ((long long)a.B + kThreads - 1) / kThreads;
  const int blocks = (int)min(need, (long long)sms * per_sm);
  if (blocks == 0) return 0;
  kernel<<<blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The launch in the instance the table takes: shared memory where it fits
// (dfa_scan.window_fits), else global memory.
template <bool kEnds>
int launch(const Lanes& a, cudaStream_t st) {
  if (a.nseg < 1 || a.ntbl < a.nseg) return (int)cudaErrorInvalidValue;
  if (smem_bytes(true, a.ntbl) <= kSmemLimit)
    return launch_in<kEnds, true>(a, st);
  return launch_in<kEnds, false>(a, st);
}

}  // namespace

extern "C" {

int cgx_window_flags(const int32_t* packed, int S, int nseg,
                     const int32_t* segmap, const int32_t* eoi,
                     const int32_t* starts_tbl, const uint8_t* data,
                     long long n, int reverse, const int32_t* starts,
                     const int32_t* edge, int B, int W, int32_t* flagw,
                     int32_t* alive, void* stream) {
  const Lanes a = {packed, nseg, S * nseg, segmap, eoi, starts_tbl, data, n,
                   reverse, starts, edge, nullptr, B, W, flagw, nullptr,
                   alive, 0};
  return launch<false>(a, (cudaStream_t)stream);
}

// edge and idx may be null; alive is uint8 when alive_u8, else int32
int cgx_window_ends(const int32_t* packed, int S, int nseg,
                    const int32_t* segmap, const int32_t* eoi,
                    const int32_t* starts_tbl, const uint8_t* data,
                    long long n, int reverse, const int32_t* starts,
                    const int32_t* edge, const int32_t* idx, int B, int W,
                    int32_t* ends, void* alive, int alive_u8, void* stream) {
  const Lanes a = {packed, nseg, S * nseg, segmap, eoi, starts_tbl, data, n,
                   reverse, starts, edge, idx, B, W, nullptr, ends, alive,
                   alive_u8};
  return launch<true>(a, (cudaStream_t)stream);
}

}  // extern "C"
