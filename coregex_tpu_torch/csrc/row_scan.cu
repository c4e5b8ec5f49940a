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
// cgx_rows_rev_start keeps one row a thread, reading its row back from the
// end in aligned 16-byte chunks (an aligned uint4 of the row: L is a
// multiple of 16 and the matrix 16-byte aligned, which RowBatch.upload and
// the wrappers see to), with the class-indexed table in shared memory where
// it fits (delta << 1 | match_on [S, C] int32, match_eoi's SOT column [S]
// as bytes, classes [256]) and in global memory otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 64;          // columns of a row a stage
constexpr int kPieces = kCols / 16;    // 16-byte pieces of a staged row
constexpr int kStageRow = kCols + 16;  // bytes between a warp's staged rows
constexpr int kStages = 2;         // stages a warp, in flight together
constexpr int kWarpStage = 32 * kStageRow;
constexpr int kRankGroups = 4;     // groups of 32 rows a warp, a tile
constexpr int kTile = kThreads * kRankGroups;   // rows a block ranks
constexpr int kKeys = 32;          // length buckets of 8 bytes
static_assert(kKeys == 32, "one warp sums the buckets");
constexpr int kByteRow = 260;      // uint8 entries a byte-table row
constexpr int kByteMaxS = 128;     // delta << 1 | match_on fits a byte

enum { kGlobal = 0, kClass = 1, kByte = 2 };

// Dynamic shared memory of cgx_rows_match: the warps' stages, match_eoi's
// SOT column, then the table of the mode (the rank's histogram and
// permutation are static, 4 * (kKeys + kTile) bytes).
size_t match_smem_bytes(int S, int C, int mode) {
  const size_t b = (size_t)(kThreads / 32) * kStages * kWarpStage +
                   ((size_t)S + 15) / 16 * 16;
  if (mode == kByte) return b + (size_t)S * kByteRow;
  if (mode == kClass) return b + (size_t)4 * S * C + 4 * 256;
  return b + 4 * 256;
}

// Dynamic shared memory of cgx_rows_rev_start.
size_t smem_bytes(int S, int C, bool shared_tables) {
  size_t b = 4 * 256;
  if (shared_tables) b += (size_t)4 * S * C + ((size_t)S + 15) / 16 * 16;
  return b;
}

struct Tables {
  const int32_t* tbl;   // [S * C] delta << 1 | match_on
  const uint8_t* eoi;   // [S] match_eoi[:, SOT]
  const int32_t* cls;   // [256]
  int C;
};

// Tables in shared memory (kShared) or global memory; classes always in
// shared memory.
template <bool kShared>
__device__ __forceinline__ Tables load_tables(const int32_t* tbl,
                                              const uint8_t* eoi,
                                              const int32_t* classes, int S,
                                              int C) {
  extern __shared__ int4 smem[];
  int32_t* cls = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i < 256; i += kThreads) cls[i] = classes[i];
  Tables tb{tbl, eoi, cls, C};
  if (kShared) {
    int32_t* t_s = cls + 256;
    uint8_t* e_s = reinterpret_cast<uint8_t*>(t_s + S * C);
    for (int i = threadIdx.x; i < S * C; i += kThreads) t_s[i] = tbl[i];
    for (int i = threadIdx.x; i < S; i += kThreads) e_s[i] = eoi[i];
    tb.tbl = t_s;
    tb.eoi = e_s;
  }
  __syncthreads();
  return tb;
}

// Byte p of a row, through a cached aligned 16-byte chunk.
struct RowReader {
  const uint8_t* row;
  int base = -1;
  uint4 chunk;

  __device__ __forceinline__ int at(int p) {
    const int b = p & ~15;
    if (b != base) {
      chunk = *reinterpret_cast<const uint4*>(row + b);
      base = b;
    }
    const int j = p & 15;
    const uint32_t w =
        j < 8 ? (j < 4 ? chunk.x : chunk.y) : (j < 12 ? chunk.z : chunk.w);
    return (w >> (8 * (j & 3))) & 255;
  }
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    rows_rev_kernel(const int32_t* __restrict__ tbl,
                    const uint8_t* __restrict__ eoi,
                    const int32_t* __restrict__ classes, int S, int C,
                    int stop_dead, const uint8_t* __restrict__ rows, int B,
                    int L, const int32_t* __restrict__ ends,
                    const int32_t* __restrict__ s0,
                    int32_t* __restrict__ starts) {
  const Tables tb = load_tables<kShared>(tbl, eoi, classes, S, C);
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int end = ends[b];
  if (end < 0) {
    starts[b] = -1;
    return;
  }
  const int steps = end < L ? end : L;
  RowReader rd{rows + b * L};
  int s = s0[b];
  int lst = -1;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int p = end - 1 - t;
    const int e = tb.tbl[s * C + tb.cls[rd.at(p < L ? p : L - 1)]];
    if (e & 1) lst = t;
    s = e >> 1;
    if (stop_dead && s == 0) break;
  }
  if (tb.eoi[s]) lst = lst > end ? lst : end;
  starts[b] = lst >= 0 ? end - lst : -1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

struct MatchArgs {
  const int32_t* tbl;
  const uint8_t* eoi;
  const int32_t* classes;
  const uint8_t* tbl_b;
  int S, C, start, stop_dead;
  const uint8_t* rows;
  int B, L;
  const int32_t* lens;
  bool* found;
  int32_t* last;
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
                        cnt, s, lst, a.stop_dead) &&
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

template <int kMode>
__global__ void __launch_bounds__(kThreads) rows_match_kernel(MatchArgs a) {
  extern __shared__ int4 smem[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem);
  uint8_t* eoi = stages + (kThreads / 32) * kStages * kWarpStage;
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

template <int kMode>
int launch_match(const MatchArgs& a, void* stream) {
  const int smem = (int)match_smem_bytes(a.S, a.C, kMode);
  auto kernel = rows_match_kernel<kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)(((long long)a.B + kTile - 1) / kTile);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename K, typename... Args>
int launch(K kernel, size_t smem, int B, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(((long long)B + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_args(int S, int C, int B, int L) {
  return S < 1 || C < 1 || B < 0 || L < 16 || L % 16;
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
                   int C,
                   int start, int stop_dead, int mode, const uint8_t* rows,
                   int B, int L, const int32_t* lens, bool* found,
                   int32_t* last, void* stream) {
  if (bad_args(S, C, B, L) || mode < kGlobal || mode > kByte ||
      (mode == kByte && S > kByteMaxS))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const MatchArgs a = {tbl, eoi, classes, tbl_b, S, C, start, stop_dead,
                       rows, B, L, lens, found, last};
  if (mode == kByte) return launch_match<kByte>(a, stream);
  if (mode == kClass) return launch_match<kClass>(a, stream);
  return launch_match<kGlobal>(a, stream);
}

// starts [B] of the rows [B, L] with known ends [B] (< 0: none) under a
// reverse DFA (tables and rows as cgx_rows_match's) from the entry states
// s0 [B].
int cgx_rows_rev_start(const int32_t* tbl, const uint8_t* eoi,
                       const int32_t* classes, int S, int C, int stop_dead,
                       int shared, const uint8_t* rows, int B, int L,
                       const int32_t* ends, const int32_t* s0,
                       int32_t* starts, void* stream) {
  if (bad_args(S, C, B, L)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(S, C, shared != 0);
#define CGX_REV(SH)                                                          \
  return launch(rows_rev_kernel<SH>, smem, B, stream, tbl, eoi, classes,    \
                S, C, stop_dead, rows, B, L, ends, s0, starts)
  if (shared) CGX_REV(true);
  CGX_REV(false);
#undef CGX_REV
}

}  // extern "C"
