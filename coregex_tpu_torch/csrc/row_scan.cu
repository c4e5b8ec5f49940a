// The row-batch DFA scans: is_match_batch and find_index_batch over a
// padded [B, L] matrix of independent rows, one row a thread.
//
// Replace coregex_tpu/ops/rowscan.py:_rows_scan (:57) and _rows_rev_scan
// (:90), two lax.scans that step a [B] state vector over the L columns in
// lockstep; no Pallas kernel.
//
// cgx_rows_match, row b of length len (the reference's step, :69-80):
//   s = starts[SOT]; last = -1
//   for t < min(len, L): c = classes[row[t]]; last = t if match_on[s, c];
//                        s = delta[s, c]
//   if 0 <= len <= L and match_eoi[s, SOT]: last = max(last, len)
//   found = last >= 0
// (the reference latches match_eoi at t == len inside its loop and after
// it for len == L: the state there is the state after min(len, L) bytes).
// cgx_rows_rev_start, row b with a known end (< 0: none) and its entry
// state s0 (the reverse DFA's start for the byte at end, :159-178, from
// rowscan.rev_start_states):
//   for t < min(end, L): p = end - 1 - t; c = classes[row[min(p, L - 1)]];
//                        last = t if match_on[s, c]; s = delta[s, c]
//   if match_eoi[s, SOT]: last = max(last, end)
//   start = end - last if last >= 0 else -1
// Both stop at the dead state 0 when the caller says that it is absorbing
// and matchless (stop_dead = 1): the rest of the row cannot change the
// result.
//
// What bounds them on an H100: the dependent chain of a step (a table
// load) times the longest row of a warp, and the bytes the walks read: a
// row is read only up to its length or its dead state, so the bytes moved
// are the rows' live bytes, not B x L.
//
// cgx_rows_match stages its rows a warp at a time.  A warp owns 32 rows;
// per stage it brings the next kCols columns of each of them that is still
// walking (a ballot of the live rows; the 16-byte pieces past a row's
// length are skipped) into shared memory with cp.async, 8 rows of kCols
// contiguous bytes an instruction, two stages in flight, so the next
// block of columns arrives while the current one is walked; each thread
// then walks its row from shared memory (rows kStageRow bytes apart, so a
// warp's 16-byte reads are free of bank conflicts), and the warp stops
// when all 32 rows have ended.  So a warp walks as long as its longest
// row: on the bench's log lines (46.6 bytes on average, 150 at most) that
// is 2.1 times the bytes the walks need.  A block therefore takes a tile
// of kTile rows and ranks them by length (buckets of 8 bytes: a shared
// histogram and a warp's prefix sum) before its warps take them 32 at a
// time in rank order; the outputs go to each row's own index.  The table
// is byte-indexed where it fits (tbl_b[s, byte] = delta << 1 | match_on at
// [s, classes[byte]], uint8 entries while S <= 128, rows kByteRow bytes
// apart, one bank on per row): one shared load a step, and on ASCII text
// a state's row spans the 32 banks once.  Otherwise the class-indexed
// table (delta << 1 | match_on [S, C] int32 and classes [256]) sits in
// shared memory where it fits, else the same kernel reads it from global
// memory (a DFA up to the determinizer's state limit).  Each block copies
// its tables once; its warps share no barrier after the rank.
//
// cgx_rows_rev_start walks few bytes a row (on the bench's lines
// `\d+\.\d+`'s reverse walks read 4.5 bytes on average: each dies within its
// number), so the forward scan's stages buy nothing there (measured slower)
// and its time goes to reaching the rows that have an end, a third of them
// or fewer.  A block takes a tile of kRevTile rows, answers at once the
// rows with no end (-1) and those with nothing to walk (end 0: the EOI flag
// of their entry state), and ranks the others by min(end, L), longest first
// (the forward scan's 8-byte buckets); its warps then claim 32 ranked rows
// at a time from a shared counter, so that no warp holds an idle row, and
// each lane walks its row back from the aligned 16-byte chunk that holds
// byte end - 1, loading the next chunk down when the walk reaches it, with
// cgx_rows_match's tables in the same three modes and no stages.  A row
// whose end lies past L reads byte L - 1 for the positions at or past L, as
// the reference's clamp does; nothing the port calls makes such an end.
// Its result is the lowest flagged position plus one, or 0 where the exit
// state's EOI flag is set (the reference's last = max(last, end): start =
// end - last).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 64;          // columns of a row a stage
constexpr int kPieces = kCols / 16;    // 16-byte pieces of a staged row
constexpr int kStageRow = kCols + 16;  // bytes between a warp's staged rows
constexpr int kStages = 2;         // stages a warp, in flight together
constexpr int kWarpStage = 32 * kStageRow;
constexpr int kStageBytes = (kThreads / 32) * kStages * kWarpStage;
constexpr int kRankGroups = 4;     // groups of 32 rows a warp, a tile
constexpr int kTile = kThreads * kRankGroups;   // rows a block ranks
constexpr int kKeys = 32;          // length buckets of 8 bytes
static_assert(kKeys == 32, "one warp sums the buckets");
constexpr int kByteRow = 260;      // uint8 entries a byte-table row
constexpr int kByteMaxS = 128;     // delta << 1 | match_on fits a byte
constexpr int kRevGroups = 4;      // groups of 32 rows a warp, a reverse tile
constexpr int kRevTile = kThreads * kRevGroups;  // rows a reverse block ranks

enum { kGlobal = 0, kClass = 1, kByte = 2 };

// Dynamic shared memory of a row kernel: stage_bytes of the warps' stages
// (cgx_rows_match's kStageBytes, none for cgx_rows_rev_start), match_eoi's
// SOT column, then the table of the mode (the ranks' histograms and
// permutations are static).
size_t match_smem_bytes(int S, int C, int mode, int stage_bytes) {
  const size_t b = (size_t)stage_bytes + ((size_t)S + 15) / 16 * 16;
  if (mode == kByte) return b + (size_t)S * kByteRow;
  if (mode == kClass) return b + (size_t)4 * S * C + 4 * 256;
  return b + 4 * 256;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// A DFA's tables as both row kernels take them.
struct TableArgs {
  const int32_t* tbl;     // [S * C] delta << 1 | match_on
  const uint8_t* eoi;     // [S] match_eoi[:, SOT]
  const int32_t* classes; // [256]
  const uint8_t* tbl_b;   // [S * kByteRow] byte-indexed (mode kByte)
  int S, C, stop_dead;
};

struct MatchArgs {
  TableArgs t;
  int start;
  const uint8_t* rows;
  int B, L;
  const int32_t* lens;
  bool* found;
  int32_t* last;
};

struct RevArgs {
  TableArgs t;
  const uint8_t* rows;
  int B, L;
  const int32_t* ends;
  const int32_t* s0;
  int32_t* starts;
};

// A step's entry delta << 1 | match_on: from the byte-indexed table, or
// from the class-indexed one (shared or global memory).
template <int kMode>
struct MatchTab {
  const uint8_t* tb;
  const int32_t* tbl;
  const int32_t* cls;
  int C;
  __device__ __forceinline__ int entry(int s, int byte) const {
    if (kMode == kByte) return tb[s * kByteRow + byte];
    return tbl[s * C + cls[byte]];
  }
};

// Walks columns c .. c + cnt - 1 of a row from its staged bytes; false
// once the walk reaches the dead state (stop_dead).
template <class Tab>
__device__ __forceinline__ bool walk_stage(const Tab& tb, const uint8_t* my,
                                           int c, int cnt, int& s, int& lst,
                                           int stop_dead) {
#pragma unroll 1
  for (int q = 0; q < kCols / 16; ++q) {
    if (16 * q >= cnt) break;
    const uint4 v = *reinterpret_cast<const uint4*>(my + 16 * q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int lim = cnt - 16 * q;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k >= lim) break;
      const int e = tb.entry(s, (w[k >> 2] >> (8 * (k & 3))) & 255);
      if (e & 1) lst = c + 16 * q + k;
      s = e >> 1;
      if (stop_dead && s == 0) return false;
    }
  }
  return true;
}

// One warp's walk of 32 rows, lane's row b (at or past B: none), through
// the warp's stages `mine`; writes the rows' found and last.
template <class Tab>
__device__ __forceinline__ void walk_group(const MatchArgs& a, const Tab& tb,
                                           const uint8_t* eoi, uint8_t* mine,
                                           int lane, long long b) {
  const unsigned full = 0xffffffffu;
  const int len = b < a.B ? a.lens[b] : -1;
  const int nb = len < 0 ? 0 : (len < a.L ? len : a.L);
  const unsigned long long row =
      reinterpret_cast<unsigned long long>(a.rows + b * a.L);
  // request columns c .. c + kCols - 1 of the rows in `want` into stage
  // st: lane l copies piece l % kPieces of rows l / kPieces + j * 32 /
  // kPieces, skipping the pieces at or past a row's length
  auto request = [&](int c, int st, unsigned want) {
    uint8_t* dst = mine + st * kWarpStage + 16 * (lane % kPieces);
    const int pc = c + 16 * (lane % kPieces);
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int r = 32 / kPieces * j + lane / kPieces;
      const int rn = __shfl_sync(full, nb, r);
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(__shfl_sync(full, row, r));
      if ((want >> r & 1) && pc < rn)
        cp_async16(dst + r * kStageRow, src + pc);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  int s = a.start, lst = -1;
  bool live = nb > 0;
  for (int k = 0; k < kStages; ++k)
    request(k * kCols, k, __ballot_sync(full, nb > k * kCols));
  int st = 0;
#pragma unroll 1
  for (int c = 0; __any_sync(full, live);
       c += kCols, st = st + 1 == kStages ? 0 : st + 1) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    if (live) {
      const int cnt = nb - c < kCols ? nb - c : kCols;
      live = walk_stage(tb, mine + st * kWarpStage + lane * kStageRow, c,
                        cnt, s, lst, a.t.stop_dead) &&
             nb > c + kCols;
    }
    __syncwarp();  // the stage is requested again
    request(c + kStages * kCols, st,
            __ballot_sync(full, live && nb > c + kStages * kCols));
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  if (b < a.B) {
    if (len >= 0 && len <= a.L && eoi[s]) lst = lst > len ? lst : len;
    a.found[b] = lst >= 0;
    a.last[b] = lst;
  }
}

// Copies match_eoi's column and the table of the mode into shared memory
// after stage_bytes of the warps' stages (`eoi` gets the column); the
// caller syncs.
template <int kMode>
__device__ __forceinline__ MatchTab<kMode> load_tables(const TableArgs& a,
                                                       uint8_t* smem,
                                                       int stage_bytes,
                                                       uint8_t*& eoi) {
  eoi = smem + stage_bytes;
  uint8_t* tab = eoi + (a.S + 15) / 16 * 16;
  for (int i = threadIdx.x; i < a.S; i += kThreads) eoi[i] = a.eoi[i];
  MatchTab<kMode> tb{};
  if (kMode == kByte) {
    // rows as 32-bit words (kByteRow is a multiple of 4)
    const uint32_t* src = reinterpret_cast<const uint32_t*>(a.tbl_b);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tab);
    for (int i = threadIdx.x; i < a.S * kByteRow / 4; i += kThreads)
      dst[i] = src[i];
    tb.tb = tab;
  } else {
    int32_t* cls = reinterpret_cast<int32_t*>(tab);
    for (int i = threadIdx.x; i < 256; i += kThreads) cls[i] = a.classes[i];
    tb.cls = cls;
    tb.C = a.C;
    tb.tbl = a.tbl;
    if (kMode == kClass) {
      int32_t* t = cls + 256;
      for (int i = threadIdx.x; i < a.S * a.C; i += kThreads) t[i] = a.tbl[i];
      tb.tbl = t;
    }
  }
  return tb;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) rows_match_kernel(MatchArgs a) {
  extern __shared__ int4 smem[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem);
  uint8_t* eoi;
  const MatchTab<kMode> tb = load_tables<kMode>(a.t, stages, kStageBytes,
                                                eoi);
  __syncthreads();
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* mine = stages + warp * kStages * kWarpStage;
  // rank the block's tile of rows by length, 8 bytes a bucket: perm[rank]
  // = row
  __shared__ int hist[kKeys];
  __shared__ int perm[kTile];
  const long long t0 = (long long)blockIdx.x * kTile;
  int key[kRankGroups], slot[kRankGroups];
  if (threadIdx.x < kKeys) hist[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRankGroups; ++i) {
    const long long r = t0 + threadIdx.x + i * kThreads;
    const int len = r < a.B ? a.lens[r] : -1;
    const int k = (len < 0 ? 0 : (len < a.L ? len : a.L)) >> 3;
    key[i] = k < kKeys ? k : kKeys - 1;
    slot[i] = atomicAdd(&hist[key[i]], 1);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sum of the buckets
    const int v = hist[lane];
    int x = v;
#pragma unroll
    for (int o = 1; o < kKeys; o <<= 1) {
      const int y = __shfl_up_sync(full, x, o);
      if (lane >= o) x += y;
    }
    hist[lane] = x - v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRankGroups; ++i)
    perm[hist[key[i]] + slot[i]] = threadIdx.x + i * kThreads;
  __syncthreads();
  // warp w walks ranks i * kThreads + 32 w .. + 31, a group at a time
#pragma unroll 1
  for (int i = 0; i < kRankGroups; ++i)
    walk_group(a, tb, eoi, mine, lane,
               t0 + perm[i * kThreads + warp * 32 + lane]);
}

// One row's reverse walk from its end (> 0) and entry state s: positions
// end - 1 down to end - min(end, L), those at or past L reading byte L - 1,
// the row read in aligned 16-byte chunks, each loaded when the walk reaches
// it; returns the row's start.
template <class Tab>
__device__ __forceinline__ int walk_rev(const Tab& tb, const uint8_t* eoi,
                                        const uint8_t* row, int L, int end,
                                        int s, int stop_dead) {
  const int lo = end - (end < L ? end : L);   // the last position walked
  int lo_flag = -1, p = end - 1;
  bool live = true;
#pragma unroll 1
  for (; p >= L && p >= lo; --p) {   // end > L only
    const int e = tb.entry(s, row[L - 1]);
    if (e & 1) lo_flag = p;
    s = e >> 1;
    if (stop_dead && s == 0) {
      live = false;
      break;
    }
  }
#pragma unroll 1
  for (int base = p & ~15; live && p >= lo; base -= 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + base));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int kh = p - base, kl = lo - base;
#pragma unroll
    for (int k = 15; k >= 0; --k) {
      if (k > kh) continue;
      if (k < kl) break;
      const int e = tb.entry(s, (w[k >> 2] >> (8 * (k & 3))) & 255);
      if (e & 1) lo_flag = base + k;
      s = e >> 1;
      if (stop_dead && s == 0) {
        live = false;
        break;
      }
    }
    p = base - 1;
  }
  return eoi[s] ? 0 : (lo_flag >= 0 ? lo_flag + 1 : -1);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) rows_rev_kernel(RevArgs a) {
  extern __shared__ int4 smem[];
  uint8_t* eoi;
  const MatchTab<kMode> tb =
      load_tables<kMode>(a.t, reinterpret_cast<uint8_t*>(smem), 0, eoi);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // rank the tile's rows that have bytes to walk by min(end, L), longest
  // first, 8 bytes a bucket: perm[rank] = row, pend[rank] = its end; the
  // others are answered here
  __shared__ int hist[kKeys];
  __shared__ int perm[kRevTile], pend[kRevTile];
  __shared__ int nrank, next;
  const long long t0 = (long long)blockIdx.x * kRevTile;
  int key[kRevGroups], slot[kRevGroups], end[kRevGroups];
  if (threadIdx.x < kKeys) hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) next = 0;
  __syncthreads();   // and the tables
#pragma unroll
  for (int i = 0; i < kRevGroups; ++i) {
    const long long r = t0 + threadIdx.x + i * kThreads;
    end[i] = r < a.B ? a.ends[r] : -1;
    key[i] = -1;
    if (end[i] > 0) {
      const int k = (end[i] < a.L ? end[i] : a.L) >> 3;
      key[i] = kKeys - 1 - (k < kKeys ? k : kKeys - 1);
      slot[i] = atomicAdd(&hist[key[i]], 1);
    } else if (r < a.B) {
      // no end, or nothing to walk: the entry state's EOI flag
      a.starts[r] = end[i] < 0 ? -1 : (eoi[a.s0[r]] ? 0 : -1);
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sum of the buckets, and their total
    const int v = hist[lane];
    int x = v;
#pragma unroll
    for (int o = 1; o < kKeys; o <<= 1) {
      const int y = __shfl_up_sync(full, x, o);
      if (lane >= o) x += y;
    }
    hist[lane] = x - v;
    if (lane == kKeys - 1) nrank = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRevGroups; ++i)
    if (key[i] >= 0) {
      perm[hist[key[i]] + slot[i]] = threadIdx.x + i * kThreads;
      pend[hist[key[i]] + slot[i]] = end[i];
    }
  __syncthreads();
  // each warp claims the next 32 ranks until none is left, one row a lane
  const int n = nrank;
#pragma unroll 1
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(&next, 1);
    g = __shfl_sync(full, g, 0);
    if (32 * g >= n) break;
    const int i = 32 * g + lane;
    if (i < n) {
      const long long b = t0 + perm[i];
      a.starts[b] = walk_rev(tb, eoi, a.rows + b * a.L, a.L, pend[i],
                             a.s0[b], a.t.stop_dead);
    }
  }
}

template <int kMode>
int launch_match(const MatchArgs& a, void* stream) {
  const int smem = (int)match_smem_bytes(a.t.S, a.t.C, kMode, kStageBytes);
  auto kernel = rows_match_kernel<kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)(((long long)a.B + kTile - 1) / kTile);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_rev(const RevArgs& a, void* stream) {
  const int smem = (int)match_smem_bytes(a.t.S, a.t.C, kMode, 0);
  auto kernel = rows_rev_kernel<kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)(((long long)a.B + kRevTile - 1) / kRevTile);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

bool bad_args(int S, int C, int B, int L, int mode) {
  return S < 1 || C < 1 || B < 0 || L < 16 || L % 16 || mode < kGlobal ||
         mode > kByte || (mode == kByte && S > kByteMaxS);
}

}  // namespace

extern "C" {

// found [B] and last [B] of the rows [B, L] with lengths lens [B] under a
// forward DFA of S states and C classes (tbl [S, C], eoi [S], classes
// [256]; for mode 2 the byte-indexed tbl_b [S, kByteRow] uint8, S <= 128)
// from state start; mode 2 walks tbl_b, 1
// the class-indexed table in shared memory, 0 in global memory (the caller
// checks that match_smem_bytes fits a block).  The rows are staged as
// aligned 16-byte pieces: L % 16 == 0 and rows 16-byte aligned.
int cgx_rows_match(const int32_t* tbl, const uint8_t* eoi,
                   const int32_t* classes, const uint8_t* tbl_b, int S,
                   int C, int start, int stop_dead, int mode,
                   const uint8_t* rows, int B, int L, const int32_t* lens,
                   bool* found, int32_t* last, void* stream) {
  if (bad_args(S, C, B, L, mode)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const MatchArgs a = {{tbl, eoi, classes, tbl_b, S, C, stop_dead}, start,
                       rows, B, L, lens, found, last};
  if (mode == kByte) return launch_match<kByte>(a, stream);
  if (mode == kClass) return launch_match<kClass>(a, stream);
  return launch_match<kGlobal>(a, stream);
}

// starts [B] of the rows [B, L] with known ends [B] (< 0: none) under a
// reverse DFA from the entry states s0 [B]; tables, table modes and rows
// as cgx_rows_match's.
int cgx_rows_rev_start(const int32_t* tbl, const uint8_t* eoi,
                       const int32_t* classes, const uint8_t* tbl_b, int S,
                       int C, int stop_dead, int mode, const uint8_t* rows,
                       int B, int L, const int32_t* ends, const int32_t* s0,
                       int32_t* starts, void* stream) {
  if (bad_args(S, C, B, L, mode)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const RevArgs a = {{tbl, eoi, classes, tbl_b, S, C, stop_dead}, rows, B,
                     L, ends, s0, starts};
  if (mode == kByte) return launch_rev<kByte>(a, stream);
  if (mode == kClass) return launch_rev<kClass>(a, stream);
  return launch_rev<kGlobal>(a, stream);
}

}  // extern "C"
