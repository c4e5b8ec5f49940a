// K10: ordered stream compaction of a byte mask in one pass, with 0-4 int32
// payloads and the switches of the compaction profiling rig.
//
// Replaces the Pallas kernel tools/_compact_exp.py:make_kernel(R, npay,
// do_route, do_dma, skip_empty, cond_dma) (launched by compact_exp at :243).
// The TPU kernel walks its grid in order on one core: each step takes a
// CH = R*128-entry block, routes the set entries to the front through a
// binary-weighted shift network, and carries the running offset and the
// partial output row to the next step in scratch memory.  Blocks on Hopper
// run in no order and nothing carries between them, so the carry becomes a
// single-pass chained scan with decoupled look-back:
//   1. each block takes a ticket with atomicAdd; the ticket, not blockIdx,
//      picks its chunk, so every block it waits on already runs (a spin
//      cannot deadlock);
//   2. it counts its CH entries with 16-byte loads, caching the chunk in
//      shared memory (the mask is read from device memory once);
//   3. it publishes its count (flag 1) in a 64-bit status word, then one
//      warp looks back 32 predecessors at a time, summing their counts
//      until it meets an inclusive prefix (flag 2); flag and value share
//      the word, written with st.release and read with ld.acquire (the
//      helpers are compact_common.cuh's, shared with compact.cu);
//   4. it publishes its own inclusive prefix;
//   5. it walks the cached chunk in sub-tiles of 4096 entries, ranks the
//      set entries (block scan of per-thread counts), stages positions and
//      payloads in order in shared memory and stores them from there at
//      its offset.  Sub-tiles keep shared memory at CH + 4096*4*(1+npay)
//      bytes (144 KB at R = 512 with 4 payloads), below the 227 KB limit.
// Switches (skip_empty and cond_dma are runtime arguments; the two timing
// ablations are template parameters, so the instantiation that gives valid
// results carries neither):
//   skip_empty  an empty block publishes and returns before staging;
//   cond_dma    a sub-tile stores only its live entries; otherwise it stores
//               the whole staged sub-tile (the TPU's overwrite write).  On
//               the TPU later grid steps overwrite the garbage tail; here a
//               later block may already have written there, so the tail is
//               clipped at the block's own output end and only the block's
//               own later sub-tiles (ordered by __syncthreads) overwrite it;
//   do_route=0  no in-block ordering: each thread stages its set entries at
//               their own sub-tile slots (results invalid; timing only);
//   do_dma=0    no global stores but the count (results invalid).
// Contract (the rig's compact_exp): pos ascending for the first cnt slots,
// payloads routed alike; the wrapper pads pos past cnt with n.
//
// What bounds it on an H100: device-memory bytes, the mask once (n bytes)
// plus the live entries' payload reads and the output stores; the
// arithmetic is a few integer ops per entry.  The look-back adds one
// status round trip per block on the critical path, overlapped with the
// other blocks' counting.

#include "compact_common.cuh"

namespace {

using cgx::kFlagAgg;
using cgx::kFlagPrefix;
using cgx::nz16;
using cgx::st_release;
using cgx::warp_incl_scan;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = kThreads * 16;   // sub-tile entries: one 16-byte load a thread

struct Pays {
  const int32_t* in[4];
  int32_t* out[4];
};

template <bool kRoute, bool kDma>
__global__ void __launch_bounds__(kThreads)
compact_exp_kernel(const uint8_t* __restrict__ mask, int nc, int ch, Pays pays,
                   int npay, int out_len, int32_t* __restrict__ pos,
                   int skip_empty, int cond_dma,
                   unsigned long long* __restrict__ status,
                   unsigned* __restrict__ ticket, int32_t* __restrict__ cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* mcache = smem;                                  // [ch] bytes
  int32_t* stage = reinterpret_cast<int32_t*>(smem + ch);  // [(1+npay)*kSub]
  __shared__ int s_block, s_excl, s_total, s_sub;
  __shared__ int warp_tot[kWarps];
  __shared__ int warp_off[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_block = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = s_block;
  const int64_t base = (int64_t)b * ch;

  // 1. count the chunk, caching it
  const uint4* src = reinterpret_cast<const uint4*>(mask + base);
  uint4* cache = reinterpret_cast<uint4*>(mcache);
  int c = 0;
  for (int i = tid; i < ch / 16; i += kThreads) {
    const uint4 v = src[i];
    cache[i] = v;
    c += __popc(nz16(v));
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) warp_tot[warp] = c;
  __syncthreads();

  // 2-4. publish, look back, publish the inclusive prefix
  if (warp == 0) {
    const int agg = __reduce_add_sync(0xffffffffu,
                                      lane < kWarps ? warp_tot[lane] : 0);
    int excl = 0;
    if (b == 0) {
      if (lane == 0) st_release(&status[0], kFlagPrefix | (unsigned)agg);
    } else {
      if (lane == 0) st_release(&status[b], kFlagAgg | (unsigned)agg);
      excl = cgx::lookback(status, b, lane);
      if (lane == 0)
        st_release(&status[b], kFlagPrefix | (unsigned)(excl + agg));
    }
    if (lane == 0) {
      s_excl = excl;
      s_total = agg;
      if (b == nc - 1) *cnt = excl + agg;
    }
  }
  __syncthreads();
  const int total = s_total;
  if (skip_empty && total == 0) return;

  // 5. rank, stage and store each sub-tile in order
  int off = s_excl;
  const int lim = min(off + total, out_len);   // the block's output end
  for (int t0 = 0; t0 < ch; t0 += kSub) {
    const unsigned bits = nz16(reinterpret_cast<const uint4*>(mcache + t0)[tid]);
    const int mine = __popc(bits);
    const int incl = warp_incl_scan(mine, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int x = lane < kWarps ? warp_tot[lane] : 0;
      const int xi = warp_incl_scan(x, lane);
      if (lane < kWarps) warp_off[lane] = xi - x;
      if (lane == kWarps - 1) s_sub = xi;
    }
    __syncthreads();
    const int live = s_sub;
    const int64_t p0 = base + t0 + 16 * tid;
    int r = kRoute ? warp_off[warp] + incl - mine : 16 * tid;
    for (unsigned m = bits; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int slot = kRoute ? r++ : 16 * tid + j;
      stage[slot] = (int32_t)(p0 + j);
      for (int k = 0; k < npay; ++k)
        stage[(k + 1) * kSub + slot] = pays.in[k][p0 + j];
    }
    __syncthreads();
    if (kDma) {
      const int wn = min(cond_dma ? live : kSub, lim - off);
      for (int i = tid; i < wn; i += kThreads) {
        pos[off + i] = stage[i];
        for (int k = 0; k < npay; ++k)
          pays.out[k][off + i] = stage[(k + 1) * kSub + i];
      }
    }
    off += live;
    __syncthreads();   // stage and warp_off are reused by the next sub-tile
  }
}

}  // namespace

extern "C" {

// mask: nc * R * 128 bytes, 16-byte aligned; outputs hold out_len int32
// each; scratch holds nc + 1 int64 (status words, then the ticket counter),
// cleared here; cnt one int32.  R in {128, 256, 512}, npay in [0, 4].
int cgx_compact_exp(const uint8_t* mask, int nc, int R, int npay,
                    const int32_t* p0, const int32_t* p1, const int32_t* p2,
                    const int32_t* p3, int out_len, int32_t* pos, int32_t* o0,
                    int32_t* o1, int32_t* o2, int32_t* o3, int do_route,
                    int do_dma, int skip_empty, int cond_dma, void* scratch,
                    int32_t* cnt, void* stream) {
  if (nc < 1 || npay < 0 || npay > 4 ||
      (R != 128 && R != 256 && R != 512))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ch = R * 128;
  unsigned long long* status = (unsigned long long*)scratch;
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  (size_t)(nc + 1) * sizeof(unsigned long long),
                                  st);
  if (e != cudaSuccess) return (int)e;
  const int smem = ch + kSub * 4 * (1 + npay);
  auto kernel = do_route ? (do_dma ? compact_exp_kernel<true, true>
                                   : compact_exp_kernel<true, false>)
                         : (do_dma ? compact_exp_kernel<false, true>
                                   : compact_exp_kernel<false, false>);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  Pays pays = {{p0, p1, p2, p3}, {o0, o1, o2, o3}};
  kernel<<<nc, kThreads, smem, st>>>(mask, nc, ch, pays, npay, out_len, pos,
                                     skip_empty, cond_dma, status,
                                     (unsigned*)(status + nc), cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
