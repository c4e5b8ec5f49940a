// The all-entries transfer walk: every piece of a sharded corpus walked
// from every state of a DFA at once.
//
// Replaces the lax.scans of coregex_tpu/parallel/shard.py:37
// (_local_transfer_fn, with the per-entry flag count of _local_flag_scan,
// :47, folded in) and coregex_tpu/parallel/sharded_count.py:83 (the count
// transducer's phase 1, and its probe's copy at :162), which step an
// [S]-vector of states over a device's shard, one gather a byte; no Pallas
// kernel.
//
// cgx_transfer_walk: D shards of m bytes lie one after another in data,
// each cut into G pieces of pl bytes (the last ones shorter, or empty);
// piece p = d * G + g holds bytes d * m + g * pl .. d * m + min((g + 1) *
// pl, m) - 1.  For every piece p and entry state e < S:
//   s = e; c = 0
//   for each byte b of the piece: v = packed[s, segmap[b]]; c += v & 31;
//                                 s = v >> 5
//   F[p, e] = s; E[p, e] = c
// packed is the lane walk's table (value = delta * 32 + emission over byte
// segments): K9's match table (emission = the match flag) gives each
// entry's flag total, K1's count table (emission = the transducer's emit)
// the matches the piece commits.  The caller composes the pieces' maps.
//
// What bounds it on an H100: the dependent table lookups, each a
// shared-memory load on its walker's chain.  Walked as written that is S
// lookups a byte; but walkers that reach one state walk on as one, and on
// the tables of real patterns every entry reaches one state (or the dead
// state) within a few dozen bytes, so the kernel walks about one walker a
// byte and is held, as K1 is, by each lane's chain of lookups and by its
// reads.  One warp takes a piece as kSub sub-pieces of sl bytes (one a
// lane):
//  A. For each sub-piece in turn the warp walks all S entries (entry
//     lane + 32 k in its k-th register, the byte a broadcast).  At each
//     16-byte chunk boundary during the first kEarly bytes, and every
//     kLate bytes after, it groups the entries that are not in a silent
//     state by state (a silent state is one that every segment maps to
//     itself with no emission: it goes nowhere and emits nothing, so an
//     entry there is final; the dead state is one, and the rule assumes
//     nothing of state 0): by __match_any_sync where S <= 32, through a
//     per-warp owner array in shared memory past that.  When there is one
//     group (or at most kMaxReps of them once kEarly bytes are walked, or
//     at once where they add no round to phase B, as the sub-pieces still
//     to come would take one walker each) and the warp's worklist has
//     room, each group's state becomes a walker on the worklist, and each
//     entry's code (its walker, -1 - index, or its silent state) and its
//     count so far go to the scratch rows X, Y [sub-piece, S].  Past 32
//     entries, a test that finds 32 groups or fewer walks their states on
//     in their place, one a lane (each entry keeping its group), so that
//     a byte costs one lookup a lane, not S / 32.  A sub-piece that never
//     merges goes on with the all-entries walk to its end, and its codes
//     are the entries' exits: tables whose walkers stay many (a
//     permutation) cost what the all-entries walk costs.
//  B. The lanes take the worklist's walkers (lane i the walkers i, i + 32,
//     ...), each walking its sub-piece's rest alone in aligned 32-byte
//     reads with the next one prefetched, stopping at a silent state.
//  C. Each lane follows entries lane, lane + 32, ... through the
//     sub-pieces' codes: F[p, e] and E[p, e] (a walker's exit, its count
//     plus the entry's own).
// The table sits in shared memory transposed, [segment][state], so that
// the entries of phase A, which read one segment at distinct states, hit
// distinct banks; where S <= 128 also indexed by byte, [byte][state] as
// int16 (a value < 2^12), so that a step is one lookup and not two.  A
// block holds up to 16 warps, so that one copy of the table serves 16
// pieces and the warps a large table leaves resident stay many.  A
// walker's count is 32 bits: the wrapper keeps pieces below 2^26 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;   // warps a block, fewer where shared memory
                                // does not hold 16 worklists
constexpr int kSub = 32;        // sub-pieces a piece (SUB)
constexpr int kItems = 128;     // walkers a warp's worklist holds (ITEMS)
constexpr int kMaxReps = 8;     // most walkers a sub-piece hands over
constexpr int kEarly = 128;     // bytes of a sub-piece before more than one
constexpr int kLate = 256;      // bytes between merge tests past kEarly
constexpr int kMaxStates = 512;
constexpr long long kSmemLimit = 232448;   // a block's on an H100
constexpr int kByteStates = 128;  // the byte-indexed table up to this S
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* packed;   // [S * nseg] delta * 32 + emission
  const int32_t* segmap;   // [256] byte -> segment
  int S, nseg;
  const uint8_t* data;     // D * m bytes, 16-byte aligned
  long long m, pl, sl;     // shard, piece and sub-piece length
  int G;                   // pieces a shard
  long long P;             // pieces: D * G
  int32_t* F;              // [P, S] exit state of each entry
  int32_t* E;              // [P, S] emission total of each entry
  int32_t* X;              // [P * kSub, S] scratch: each entry's code
  int32_t* Y;              // [P * kSub, S] scratch: its count before it
};

// The table in shared memory: [segment][state] (seg[b] = segment * S),
// and [byte][state] where BT.
template <bool BT>
struct Table {
  const int32_t* seg;
  const int32_t* tt;
  const int16_t* tb;
  int S;

  __device__ __forceinline__ int row(int b) const {
    return BT ? b * S : seg[b];
  }
  __device__ __forceinline__ int at(int row, int s) const {
    return BT ? (int)tb[row + s] : tt[row + s];
  }
};

// A warp's worklist, compacted walkers and owner array in shared memory.
struct Work {
  int* off;         // where each walker starts, from the piece's start
  int* st;          // its state there
  int* fin;         // its exit
  int* cnt;         // its emission total from there
  int* wst;         // [32] the compacted walkers' states
  int16_t* own;     // [S] owner array: a state's leader, then its number
};

__host__ __device__ constexpr long long pad8(long long x) {
  return (x + 7) & ~7LL;
}

// Dynamic shared memory: the segment map and the table, the byte-indexed
// table, the silent flags, then each of `warps` warps' worklist,
// compacted walkers and owner array.
__host__ __device__ constexpr long long tb_offset(int S, int nseg) {
  return pad8(4LL * (256 + (long long)S * nseg));
}

__host__ __device__ constexpr long long sil_offset(int S, int nseg) {
  return tb_offset(S, nseg) + (S <= kByteStates ? pad8(2LL * 256 * S) : 0);
}

__host__ __device__ constexpr long long warp_bytes(int S) {
  return kItems * 16LL + 32 * 4 + pad8(2LL * S);
}

__host__ long long smem_bytes(int S, int nseg, int warps) {
  return sil_offset(S, nseg) + pad8(S) + warps * warp_bytes(S);
}

__device__ __forceinline__ uint4 load16(const uint8_t* data, long long c) {
  return __ldg(reinterpret_cast<const uint4*>(data + c));
}

__device__ __forceinline__ int byte_at(const uint32_t* w, int b) {
  return (w[b >> 2] >> (8 * (b & 3))) & 255;
}

// One byte b for the K states of a lane.
template <int K, bool BT>
__device__ __forceinline__ void step_all(const Table<BT>& t, int b,
                                         int (&s)[K], int (&c)[K]) {
  const int r = t.row(b);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = t.at(r, s[k]);
    c[k] += v & 31;
    s[k] = v >> 5;
  }
}

// Groups the live slots (slot k of a lane: index lane + 32 k < n, in a
// state that is not silent) by state: returns R, the distinct states,
// numbered 0 .. R - 1 in the order of their leaders (one slot each);
// rank[k] is the number of the slot's state, -1 for a slot not live.
// Warp-uniform.
template <int K>
__device__ int group(const uint8_t* sil, int16_t* own, int n, int lane,
                     const int (&s)[K], int (&rank)[K], bool (&lead)[K]) {
  bool live[K];
#pragma unroll
  for (int k = 0; k < K; ++k) live[k] = lane + 32 * k < n && !sil[s[k]];
  const unsigned lt = (1u << lane) - 1;
  if (K == 1) {
    const unsigned same =
        __match_any_sync(kFull, live[0] ? s[0] : (1 << 16) + lane);
    const int leader = __ffs(same) - 1;
    lead[0] = live[0] && leader == lane;
    const unsigned leads = __ballot_sync(kFull, lead[0]);
    const int r = __shfl_sync(kFull, __popc(leads & lt), leader);
    rank[0] = live[0] ? r : -1;
    return __popc(leads);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live[k]) own[s[k]] = (int16_t)(lane + 32 * k);
  __syncwarp();
  unsigned leads[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lead[k] = live[k] && own[s[k]] == lane + 32 * k;
    leads[k] = __ballot_sync(kFull, lead[k]);
  }
  __syncwarp();
  int base = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lead[k]) own[s[k]] = (int16_t)(base + __popc(leads[k] & lt));
    base += __popc(leads[k]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) rank[k] = live[k] ? own[s[k]] : -1;
  __syncwarp();
  return base;
}

// Puts the leaders' states on the worklist as walkers nitems + rank,
// starting at `off`, and gives each slot its code: its walker (-1 -
// index), or its own silent state.
template <int K>
__device__ void push(const Work& w, int off, int nitems, const int (&rank)[K],
                     const bool (&lead)[K], int (&s)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lead[k]) {
      w.off[nitems + rank[k]] = off;
      w.st[nitems + rank[k]] = s[k];
    }
    if (rank[k] >= 0) s[k] = -1 - (nitems + rank[k]);
  }
}

// The entries of a compacted sub-piece: lvl[k] is the entry's group, a
// walker of the compacted set, or -1 - its silent state; each takes its
// walker's code (wcode, held by lane walker) and adds its count.
template <int K>
__device__ void resolve(int (&lvl)[K], int (&c)[K], int wcode, int wc) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int src = lvl[k] < 0 ? 0 : lvl[k];
    const int code = __shfl_sync(kFull, wcode, src);
    const int cn = __shfl_sync(kFull, wc, src);
    if (lvl[k] >= 0) c[k] += cn;
    lvl[k] = lvl[k] < 0 ? -1 - lvl[k] : code;
  }
}

// One walker from state st at the chunk boundary `from` to `to`, in
// aligned 32-byte reads (after a 16-byte one where `from` is not 32-byte
// aligned), the next one prefetched; stops at a silent state.
template <bool BT>
__device__ __forceinline__ void walk_one(const uint8_t* data,
                                         const Table<BT>& t,
                                         const uint8_t* sil, long long from,
                                         long long to, int& st, int& cnt) {
  if (from < to && (from & 16)) {
    const uint4 q = load16(data, from);
    const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
    const int kh = to - from < 16 ? (int)(to - from) : 16;
#pragma unroll 1
    for (int b = 0; b < kh; ++b) {
      const int v = t.at(t.row(byte_at(w4, b)), st);
      cnt += v & 31;
      st = v >> 5;
    }
    from += 16;
  }
  if (from >= to) return;
  uint4 c0 = load16(data, from);
  uint4 c1 = from + 16 < to ? load16(data, from + 16) : c0;
#pragma unroll 1
  for (long long c = from; c < to; c += 32) {
    uint4 n0 = c0, n1 = c1;
    if (c + 32 < to) {
      n0 = load16(data, c + 32);
      if (c + 48 < to) n1 = load16(data, c + 48);
    }
    if (sil[st]) break;
    const uint32_t w8[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    if (to - c >= 32) {
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const int v = t.at(t.row(byte_at(w8, b)), st);
        cnt += v & 31;
        st = v >> 5;
      }
    } else {
      const int kh = (int)(to - c);
#pragma unroll 1
      for (int b = 0; b < kh; ++b) {
        const int v = t.at(t.row(byte_at(w8, b)), st);
        cnt += v & 31;
        st = v >> 5;
      }
    }
    c0 = n0;
    c1 = n1;
  }
}

// K: the entries a lane holds, ceil(S / 32) or more; the byte-indexed
// table where S <= kByteStates (K * 32 <= kByteStates: kByteStates is a
// multiple of 32).
template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32) transfer_kernel(Args a) {
  constexpr bool BT = K * 32 <= kByteStates;
  const int nt = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S;
  int32_t* seg = reinterpret_cast<int32_t*>(smem);   // [256] segment * S
  int32_t* tt = seg + 256;                            // [nseg, S]
  int16_t* tb = reinterpret_cast<int16_t*>(smem + tb_offset(S, a.nseg));
  uint8_t* sil = smem + sil_offset(S, a.nseg);        // [S] silent flags
  for (int i = threadIdx.x; i < 256; i += nt) seg[i] = a.segmap[i] * S;
  for (int i = threadIdx.x; i < S * a.nseg; i += nt) {
    const int s = i / a.nseg;
    tt[(i - s * a.nseg) * S + s] = a.packed[i];
  }
  __syncthreads();
  if (BT) {
    for (int i = threadIdx.x; i < 256 * S; i += nt)
      tb[i] = (int16_t)tt[seg[i / S] + i % S];
  }
  for (int s = threadIdx.x; s < S; s += nt) {
    bool q = true;
    for (int k = 0; k < a.nseg; ++k) q &= tt[k * S + s] == s * 32;
    sil[s] = q;
  }
  __syncthreads();
  const Table<BT> t = {seg, tt, tb, S};

  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * (nt >> 5) + wi;
  if (p >= a.P) return;
  unsigned char* wb = smem + sil_offset(S, a.nseg) + pad8(S) +
                      wi * warp_bytes(S);
  Work w;
  w.off = reinterpret_cast<int*>(wb);
  w.st = w.off + kItems;
  w.fin = w.st + kItems;
  w.cnt = w.fin + kItems;
  w.wst = w.cnt + kItems;
  w.own = reinterpret_cast<int16_t*>(w.wst + 32);

  const long long d = p / a.G, g = p - d * a.G;
  const long long lo = d * a.m + (g * a.pl < a.m ? g * a.pl : a.m);
  const long long hi = d * a.m + ((g + 1) * a.pl < a.m ? (g + 1) * a.pl : a.m);
  const long long sl = a.sl;
  const int nsub = lo < hi ? (int)((hi - lo + sl - 1) / sl) : 0;
  int32_t* X = a.X + (size_t)p * kSub * S;
  int32_t* Y = a.Y + (size_t)p * kSub * S;
  int nitems = 0;

  // A: each sub-piece from all entries until its walkers merge
#pragma unroll 1
  for (int j = 0; j < nsub; ++j) {
    const long long sa = lo + j * sl;
    const long long sb = sa + sl < hi ? sa + sl : hi;
    // the entries' states (after a compaction, their groups) and counts;
    // at the end, their codes
    int s[K], c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = lane + 32 * k < S ? lane + 32 * k : 0;
      c[k] = 0;
    }
    // past K = 1, once the live states are 32 or fewer, the warp walks
    // them alone, one a lane (ws, wc: lane's walker of nw)
    bool compact = false, done = false;
    int ws[1] = {0}, wc[1] = {0}, nw = 0;
    // walkers the sub-pieces still to come would add, one each
    const int rest = nsub - 1 - j;
    long long at = sa, tested = sa;
    uint4 cur = load16(a.data, sa & ~15LL);
#pragma unroll 1
    while (at < sb) {
      const long long c0 = at & ~15LL;
      const long long end = c0 + 16 < sb ? c0 + 16 : sb;
      const uint4 nxt = end < sb ? load16(a.data, end) : cur;
      const uint32_t w4[4] = {cur.x, cur.y, cur.z, cur.w};
      const int kl = (int)(at - c0), kh = (int)(end - c0);
      if (compact) {
#pragma unroll 1
        for (int b = kl; b < kh; ++b) step_all<1>(t, byte_at(w4, b), ws, wc);
      } else if (kl == 0 && kh == 16) {
#pragma unroll
        for (int b = 0; b < 16; ++b) step_all<K>(t, byte_at(w4, b), s, c);
      } else {
#pragma unroll 1
        for (int b = kl; b < kh; ++b) step_all<K>(t, byte_at(w4, b), s, c);
      }
      cur = nxt;
      at = end;
      if (at == sb || (at - sa >= kEarly && at - tested < kLate)) continue;
      tested = at;
      int rank[K], wrank[1];
      bool lead[K], wlead[1];
      const int R = compact ? group<1>(sil, w.own, nw, lane, ws, wrank, wlead)
                            : group<K>(sil, w.own, S, lane, s, rank, lead);
      const bool take =
          nitems + R <= kItems &&
          (R <= 1 || (R <= kMaxReps &&
                      (at - sa >= kEarly ||
                       (nitems + R + rest + 31) / 32 <=
                           (nitems + 1 + rest + 31) / 32)));
      if (take) {
        const int off = (int)(at - lo);
        if (compact) {
          push<1>(w, off, nitems, wrank, wlead, ws);
          resolve<K>(s, c, ws[0], wc[0]);
        } else {
          push<K>(w, off, nitems, rank, lead, s);
        }
        nitems += R;
        done = true;
        break;
      }
      if (K > 1 && !compact && R <= 32) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (lead[k]) w.wst[rank[k]] = s[k];
        __syncwarp();
        nw = R;
        ws[0] = lane < R ? w.wst[lane] : 0;
        __syncwarp();
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] = rank[k] >= 0 ? rank[k] : -1 - s[k];
        compact = true;
      }
    }
    if (compact && !done) resolve<K>(s, c, ws[0], wc[0]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = lane + 32 * k;
      if (e < S) {
        X[(size_t)j * S + e] = s[k];
        Y[(size_t)j * S + e] = c[k];
      }
    }
  }
  __syncwarp();

  // B: the walkers, one a lane
#pragma unroll 1
  for (int i = lane; i < nitems; i += 32) {
    const int off = w.off[i];
    const long long end = lo + (off / sl + 1) * sl;
    int st = w.st[i], cn = 0;
    walk_one<BT>(a.data, t, sil, lo + off, end < hi ? end : hi, st, cn);
    w.fin[i] = st;
    w.cnt[i] = cn;
  }
  __syncwarp();

  // C: every entry through the sub-pieces' codes
#pragma unroll 1
  for (int e = lane; e < S; e += 32) {
    int st = e, cn = 0;
#pragma unroll 1
    for (int j = 0; j < nsub && !sil[st]; ++j) {
      const size_t i = (size_t)j * S + st;
      const int x = X[i];
      cn += Y[i];
      if (x < 0) {
        cn += w.cnt[-1 - x];
        st = w.fin[-1 - x];
      } else {
        st = x;
      }
    }
    a.F[(size_t)p * S + e] = st;
    a.E[(size_t)p * S + e] = cn;
  }
}

// A block of up to kMaxWarps warps, as many as shared memory holds with
// the table: its copy is shared by more walkers, and more of them stay
// resident where the table is large.
template <int K>
int launch(const Args& a, cudaStream_t stream) {
  int warps = kMaxWarps;
  while (warps > 1 && smem_bytes(a.S, a.nseg, warps) > kSmemLimit) warps /= 2;
  const long long smem = smem_bytes(a.S, a.nseg, warps);
  const long long blocks = (a.P + warps - 1) / warps;
  if (smem > kSmemLimit || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      transfer_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  transfer_kernel<K><<<(int)blocks, warps * 32, (int)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// F [P, S] and E [P, S] of the P = D * G pieces of data (see above) under
// the table packed [S, nseg] and segmap [256], held in dynamic shared
// memory with each warp's worklist (transfer_scan.smem_bytes); X and Y
// [P * 32, S] are scratch.  data must be 16-byte aligned; the kernel reads
// the aligned 16-byte chunks that hold the pieces' bytes.  S <= 512.
int cgx_transfer_walk(const int32_t* packed, int S, int nseg,
                      const int32_t* segmap, const uint8_t* data,
                      long long m, long long pl, int G, int D, int32_t* F,
                      int32_t* E, int32_t* X, int32_t* Y, void* stream) {
  if (S < 1 || S > kMaxStates || nseg < 1 || G < 1 || D < 1 || m < 1 ||
      pl < 16 || pl % 16 || pl * G < m || pl > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long q = (pl + kSub - 1) / kSub;
  const long long sl = q < 16 ? 16 : (q + 15) / 16 * 16;
  const long long P = (long long)D * G;
  const Args a = {packed, segmap, S, nseg, data, m, pl, sl, G, P, F, E, X, Y};
  cudaStream_t st = (cudaStream_t)stream;
  switch ((S + 31) / 32) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    case 5: return launch<5>(a, st);
    case 6: return launch<6>(a, st);
    case 7: case 8: return launch<8>(a, st);
    case 9: case 10: case 11: case 12: return launch<12>(a, st);
    default: return launch<16>(a, st);
  }
}

}  // extern "C"
