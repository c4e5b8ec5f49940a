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
// What bounds it on an H100: the dependent chain of a step (class load,
// table load) times the longest row of a warp; a row is read only up to its
// length or its dead state, so the bytes moved are the rows' bytes, not
// B x L.  The rows are read 16 bytes at a time (an aligned uint4 of the
// row: L is a multiple of 16 and the matrix 16-byte aligned, which
// RowBatch.upload and the wrappers see to), which a row-major matrix serves
// from separate 32-byte sectors per thread: half a sector wasted, not
// coalesced.  A time-major layout is
// later work.  The tables sit in shared memory when they fit: delta and
// match_on packed as delta << 1 | match_on [S, C] int32, match_eoi's SOT
// column [S] as bytes, classes [256]; a larger DFA (up to the
// determinizer's state limit) is read from global memory by the same
// kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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
    rows_match_kernel(const int32_t* __restrict__ tbl,
                      const uint8_t* __restrict__ eoi,
                      const int32_t* __restrict__ classes, int S, int C,
                      int start, int stop_dead,
                      const uint8_t* __restrict__ rows, int B, int L,
                      const int32_t* __restrict__ lens,
                      bool* __restrict__ found, int32_t* __restrict__ last) {
  const Tables tb = load_tables<kShared>(tbl, eoi, classes, S, C);
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int len = lens[b];
  const int nb = len < 0 ? 0 : (len < L ? len : L);
  RowReader rd{rows + b * L};
  int s = start;
  int lst = -1;
#pragma unroll 1
  for (int t = 0; t < nb; ++t) {
    const int e = tb.tbl[s * C + tb.cls[rd.at(t)]];
    if (e & 1) lst = t;
    s = e >> 1;
    if (stop_dead && s == 0) break;
  }
  if (len >= 0 && len <= L && tb.eoi[s]) lst = lst > len ? lst : len;
  found[b] = lst >= 0;
  last[b] = lst;
}

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
// [256]) from state start; shared = 1 holds the tables in shared memory
// (the caller checks that smem_bytes fits a block).  The rows are read as
// aligned 16-byte chunks: L % 16 == 0 and rows 16-byte aligned.
int cgx_rows_match(const int32_t* tbl, const uint8_t* eoi,
                   const int32_t* classes, int S, int C, int start,
                   int stop_dead, int shared, const uint8_t* rows, int B,
                   int L, const int32_t* lens, bool* found, int32_t* last,
                   void* stream) {
  if (bad_args(S, C, B, L)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(S, C, shared != 0);
#define CGX_ROWS(SH)                                                         \
  return launch(rows_match_kernel<SH>, smem, B, stream, tbl, eoi, classes,  \
                S, C, start, stop_dead, rows, B, L, lens, found, last)
  if (shared) CGX_ROWS(true);
  CGX_ROWS(false);
#undef CGX_ROWS
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
