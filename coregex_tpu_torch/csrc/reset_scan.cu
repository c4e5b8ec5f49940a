// The reset scan (cgx_reset_scan): a lane-chunked anchored DFA walk that
// restarts at the anchored start state at every marked byte, one lane a
// thread.
//
// Replaces coregex_tpu/ops/dfa_scan.py:_chunk_scan_reset (:685), two
// lax.scan loops (a warmup and the lane's bytes) inside a while_loop repair
// (:771), behind ResetScanner (:781); no Pallas kernel.  The corpus arrives
// as one byte a position, packed = segment << 3 | ctx << 1 | reset, where
// ctx is the context of the byte before (CTX_*, the start state's row) and
// segment the byte's table column (at most 32 columns).  One step at a
// byte x in state s:
//   reset: interfered += (s != DEAD); s = starts[ctx]
//   v = tbl[s, segment]; flag = v & 1; s = v >> 1
// Lane l walks bytes [l*T, l*T + T) from entries[l], after a warmup over
// the W bytes before them (those of lane l - 1, wrapping round as jnp.roll
// does) whose steps before offsets[l] are skipped.  It writes the flag of
// each byte as bit t % 32 of word [t / 32, l] (time-major, so a warp's
// stores are one row of neighbouring words), its state after the warmup
// (sync), after its bytes (exits) and the resets that met a live state.
// The Python side (ops/dfa_scan.py) runs the reference's repair: rescans
// from the previous lanes' exits while any lane's sync disagrees, at most
// max_repair times.
//
// What bounds it on an H100: the walk, a chain of dependent table reads a
// byte, and the corpus read (n bytes; the flags are n / 8).  The table sits
// in shared memory (S * C * 4 bytes; global memory past it); each lane
// reads its bytes 16 at a time (ld.global.nc of an aligned uint4 when T is
// a multiple of 16, else a byte at a time).  A lane a thread gives 65,536
// walkers at the reference's geometry (SEG_LIMIT = 2^29 bytes a launch),
// a quarter of the card's resident threads: simple and right first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxShared = 200 * 1024;

struct Args {
  const uint8_t* packed;   // [L * T] bytes, lane-major
  int L, T, W;
  const int32_t* tbl;      // [S, C] delta << 1 | match
  int S, C;
  const int32_t* starts;   // [4] start state by context
  const int32_t* entries;  // [L]
  const int32_t* offsets;  // [L]
  int32_t* flagw;          // [ceil(T / 32), L]
  int32_t* exits;          // [L]
  int32_t* sync;           // [L]
  int32_t* interf;         // [L]
};

template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kThreads)
reset_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int32_t* tb = a.tbl;
  if (kShared) {
    for (int i = threadIdx.x; i < a.S * a.C; i += kThreads)
      smem[i] = a.tbl[i];
    __syncthreads();
    tb = smem;
  }
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= a.L) return;
  const int C = a.C;
  int st[4];
  for (int i = 0; i < 4; ++i) st[i] = a.starts[i];
  int s = a.entries[l];
  // warmup: the W bytes before the lane (the previous lane's tail)
  const uint8_t* prev =
      a.packed + (size_t)((l + a.L - 1) % a.L) * a.T + (a.T - a.W);
  for (int t = a.offsets[l]; t < a.W; ++t) {
    const int x = __ldg(prev + t);
    if (x & 1) s = st[(x >> 1) & 3];
    s = tb[s * C + (x >> 3)] >> 1;
  }
  a.sync[l] = s;
  int cnt = 0;
  uint32_t word = 0;
  const uint8_t* row = a.packed + (size_t)l * a.T;
  int32_t* out = a.flagw + l;
  auto step = [&](int x, int t) {
    if (x & 1) {
      cnt += (s != 0);
      s = st[(x >> 1) & 3];
    }
    const int v = tb[s * C + (x >> 3)];
    word |= (uint32_t)(v & 1) << (t & 31);
    s = v >> 1;
    if ((t & 31) == 31) {
      out[(size_t)(t >> 5) * a.L] = (int32_t)word;
      word = 0;
    }
  };
  if (kVec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int t0 = 0; t0 < a.T; t0 += 16) {
      const uint4 q = __ldg(row4 + (t0 >> 4));
      const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        step((int)((w4[j >> 2] >> (8 * (j & 3))) & 0xFF), t0 + j);
    }
  } else {
    for (int t = 0; t < a.T; ++t) step(__ldg(row + t), t);
  }
  if (a.T & 31) out[(size_t)(a.T >> 5) * a.L] = (int32_t)word;
  a.exits[l] = s;
  a.interf[l] = cnt;
}

template <bool kShared, bool kVec>
int launch(const Args& a, int smem, void* stream) {
  auto kernel = reset_kernel<kShared, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.L + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass of the reset scan over L lanes of T bytes (W warmup bytes
// before each); the caller pads `packed` to L * T bytes with zeros.
int cgx_reset_scan(const uint8_t* packed, int L, int T, int W,
                   const int32_t* tbl, int S, int C, const int32_t* starts,
                   const int32_t* entries, const int32_t* offsets,
                   int32_t* flagw, int32_t* exits, int32_t* sync,
                   int32_t* interf, void* stream) {
  if (L < 1 || T < 1 || W < 0 || W > T || S < 1 || C < 1 || C > 32)
    return (int)cudaErrorInvalidValue;
  const Args a = {packed, L, T, W, tbl, S, C, starts, entries, offsets,
                  flagw, exits, sync, interf};
  const long long tb = (long long)S * C * 4;
  const bool vec = (T % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(packed) % 16 == 0);
  if (tb <= kMaxShared) {
    return vec ? launch<true, true>(a, (int)tb, stream)
               : launch<true, false>(a, (int)tb, stream);
  }
  return vec ? launch<false, true>(a, 0, stream)
             : launch<false, false>(a, 0, stream);
}

}  // extern "C"
