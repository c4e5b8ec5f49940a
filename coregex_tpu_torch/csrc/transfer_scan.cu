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
// What bounds it on an H100: the S * n dependent table lookups, each
// walker's chain of shared-memory loads, not the n bytes it reads (one
// pass over the corpus at 3.35 TB/s).  One warp walks one piece from up to
// 32 entry states at once (lane e of the warp, entry chunk * 32 + e); where
// S < 32, floor(32 / S) pieces share a warp, S lanes each.  Each lane reads
// its piece as aligned 16-byte chunks through the read-only cache, the next
// chunk loaded while the current one is walked; lanes of one piece read the
// same chunk, which the hardware serves as one broadcast.  The table sits
// in shared memory transposed, [segment][state], so the lanes of one piece,
// which read one segment at distinct states, hit distinct banks (and the
// same word once their states have converged); the segment map holds
// segment * S, which depends on the byte alone and so stays off the chain
// of a step.  A walker's count is 32 bits: the wrapper keeps pieces below
// 2^26 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Args {
  const int32_t* packed;   // [S * nseg] delta * 32 + emission
  const int32_t* segmap;   // [256] byte -> segment
  int S, nseg;
  const uint8_t* data;     // D * m bytes, 16-byte aligned
  long long m, pl;         // shard and piece length
  int G;                   // pieces a shard
  long long P;             // pieces: D * G
  int32_t* F;              // [P, S] exit state of each entry
  int32_t* E;              // [P, S] emission total of each entry
};

__global__ void __launch_bounds__(kThreads) transfer_kernel(Args a) {
  extern __shared__ int32_t smem[];
  int32_t* seg = smem;         // [256] segment * S
  int32_t* tt = smem + 256;    // [nseg, S]
  const int S = a.S;
  for (int i = threadIdx.x; i < 256; i += kThreads) seg[i] = a.segmap[i] * S;
  for (int i = threadIdx.x; i < S * a.nseg; i += kThreads) {
    const int s = i / a.nseg;
    tt[(i - s * a.nseg) * S + s] = a.packed[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  long long p;
  int e;
  bool ok;
  if (S >= 32) {
    const int chunks = (S + 31) >> 5;
    p = w / chunks;
    e = (int)(w - p * chunks) * 32 + lane;
    ok = e < S && p < a.P;
  } else {
    const int k = 32 / S;
    p = w * k + lane / S;
    e = lane - lane / S * S;
    ok = lane < k * S && p < a.P;
  }
  if (!ok) return;
  const long long d = p / a.G, g = p - d * a.G;
  const long long lo = d * a.m + g * a.pl;
  const long long end = (g + 1) * a.pl < a.m ? (g + 1) * a.pl : a.m;
  const long long hi = d * a.m + end;
  int s = e, cnt = 0;
  if (lo < hi) {
    long long c = lo & ~15LL;
    uint4 cur = __ldg(reinterpret_cast<const uint4*>(a.data + c));
#pragma unroll 1
    for (; c < hi; c += 16) {
      const uint4 nxt =
          c + 16 < hi ? __ldg(reinterpret_cast<const uint4*>(a.data + c + 16))
                      : cur;
      const uint32_t w4[4] = {cur.x, cur.y, cur.z, cur.w};
      const int kl = c < lo ? (int)(lo - c) : 0;
      const int kh = hi - c < 16 ? (int)(hi - c) : 16;
      if (kl == 0 && kh == 16) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int v = tt[seg[(w4[k >> 2] >> (8 * (k & 3))) & 255] + s];
          cnt += v & 31;
          s = v >> 5;
        }
      } else {
#pragma unroll 1
        for (int k = kl; k < kh; ++k) {
          const int v = tt[seg[(w4[k >> 2] >> (8 * (k & 3))) & 255] + s];
          cnt += v & 31;
          s = v >> 5;
        }
      }
      cur = nxt;
    }
  }
  a.F[p * S + e] = s;
  a.E[p * S + e] = cnt;
}

}  // namespace

extern "C" {

// F [P, S] and E [P, S] of the P = D * G pieces of data (see above) under
// the table packed [S, nseg] and segmap [256], held in dynamic shared
// memory ((256 + S * nseg) * 4 bytes: count_scan.table_fits).  data must be
// 16-byte aligned; the kernel reads the aligned 16-byte chunks that hold
// the pieces' bytes.
int cgx_transfer_walk(const int32_t* packed, int S, int nseg,
                      const int32_t* segmap, const uint8_t* data,
                      long long m, long long pl, int G, int D, int32_t* F,
                      int32_t* E, void* stream) {
  if (S < 1 || nseg < 1 || G < 1 || D < 1 || m < 1 || pl < 1 ||
      pl * G < m)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)D * G;
  const long long warps =
      S >= 32 ? P * ((S + 31) / 32) : (P + 32 / S - 1) / (32 / S);
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)(4LL * (256 + (long long)S * nseg));
  cudaError_t err = cudaFuncSetAttribute(
      transfer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Args a = {packed, segmap, S, nseg, data, m, pl, G, P, F, E};
  transfer_kernel<<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
