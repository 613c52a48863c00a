// Paged decode attention over a block table, online softmax, written for
// Hopper (sm_90a): fp32 on the CUDA cores up to 8 query heads per KV head,
// TF32 on the tensor cores from 9 to 16 (the second kernel, below).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py:
// flash_decode (one decode step's attention for every slot of the batch,
// KV in a shared block pool addressed through per-row block tables):
//
//   out[b, g, r, :] = sum_t softmax_t(q[b, g, r, :] . K[b, t, g, :]) V[b, t, g, :]
//
// over the live positions t < kv_lens[b] of row b, where position t lives in
// physical block table[b, t / bs] at offset t % bs.  q [B, G, rep, DH] fp32,
// already scaled by DH^-0.5; K/V pools [NBP, bs, G, DH] bf16, or int8 with
// fp32 scales [NBP, bs, G, 1] per (token, head); table [B, W] int32;
// kv_lens [B] int32; out [B, G, rep, DH] fp32.  A row with kv_lens = 0
// gives exact zeros, as the Pallas kernel does; a block id outside
// [0, NBP) is masked, never read.
//
// Bound on the H100 (SXM, 3.35 TB/s): by bytes, the K/V of the live
// positions.  A decode step of Llama 3.2 3B at 32 slots and a mean live
// length of 261 reads 32 x 261 x 8 heads x 128 x 2 (K, V) x 2 bytes =
// 34.2 MB (10.4 us; int8 17.6 MB with its scales, 5.5 us) against
// 4 x 32 x 261 x 8 x 3 x 128 = 0.10 GFLOP (1.5 us at the fp32 rate).  At
// rep = 3 a wgmma tile (M = 64) would be 95 % padding, so the products stay
// on the CUDA cores.  What held the first version of this kernel back was
// latency and instruction count, not bytes: one block walked a whole row,
// so the longest row set the time, and each tile waited on its loads.
//
// Design, one launch:
//   * Split-KV over a thread-block cluster.  The grid is (S, G, B) with
//     cluster dims (S, 1, 1), S in 1..8 chosen on the host from static
//     shapes (kernel.py: split_count).  Block `rank` of the (row, KV head)
//     cluster takes positions [rank * c, min((rank + 1) * c, len)), c =
//     ceil(len / S) rounded up to a warp's batch (kernel.py: tile), so a
//     long row is spread over S SMs.
//   * The block stages the pool row of each of its positions in shared
//     memory once (kRowsMax at a time): no K/V load waits on a table read,
//     and a block id outside the pool is masked there.
//   * Warps own positions, and K/V stays in its storage type until it
//     reaches registers.  A lane copies 8 values of a row (16 bytes bf16, 8
//     bytes int8); DH / 8 lanes cover a row, a warp 256 / DH rows per copy,
//     a batch kDepth copies of K and of V.  Each warp streams its batches
//     through its own ring of kStages in shared memory with cp.async (16-byte
//     .cg copies for bf16), two or four batches ahead, so its loads are in
//     flight while it computes; it waits on its own copies only, and the
//     block's warps take the batches of a pass together, so the loop, and
//     every shuffle in it, is uniform.  No block-wide barrier in the loop.
//   * Per batch: the partial products of the rep query heads (held in
//     registers) with the batch's positions are summed over a row's lanes
//     by a transposed butterfly, each lane keeping a share, so the max and
//     the exponentials are spread over the lanes and the probabilities are
//     gathered back with one shuffle each; each warp keeps its own
//     (m, l, acc) in fp32.  The int8 scale multiplies the score (K) and the
//     probability (V): the same product, 2 multiplies where widening would
//     take 16.  rep is a template parameter, so nothing in the loop
//     branches on it.
//   * Merges in a fixed order: warps in warp order through shared memory,
//     then each rank merges a slice of the row's outputs over its peers'
//     (m, l, acc), read through distributed shared memory in rank order,
//     and writes acc / max(l, 1e-30).  An empty range leaves m = -1e30,
//     l = 0, acc = 0, so a row of length 0 merges to exact zeros.  The
//     second cluster.sync() keeps every block resident until its peers have
//     read its shared memory: no block may return early.
//   * fp32 sums, expf (not __expf: the contract with the plain version is
//     2e-5); no atomics: the same bits every run.
//
// 9-16 query heads per KV head (starcoder2-3b: rep 12), the tensor-core
// kernel (flash_decode_wide_kernel).  Bound by bytes at every shape the
// configs use: starcoder2's decode step at 32 slots, mean live length 269,
// reads 9.6 MB of K/V (2.86 us) against 0.11 GFLOP of attention (1.6 us at
// the fp32 rate).  On the CUDA cores the query heads' registers spilled
// (rep 12: 104-268 bytes a thread), a batch was 4 positions and a fp32 FMA
// a multiply: 31.6 us.  Design:
//   * The rep heads of a (row, KV head) are the M = 16 rows of
//     mma.sync.m16n8k8 TF32 products with fp32 sums (heads past rep zero,
//     never written); a warp takes 8 positions (one n-tile) at a time:
//     S = Q K^T over dh / 8 k-steps, then O += P V over its n-tiles of dh.
//     One instantiation a (dh, pool type); rep is an argument.
//   * Exactness: K and V enter as they are (bf16 widened, int8 before its
//     scale: both exact in TF32); q and P as two TF32 terms each, hi =
//     rna(x), lo = rna(x - hi): S = q_hi K + q_lo K, O += P_hi V + P_lo V.
//     The k scale multiplies S's column, the v scale P's column.  One term
//     misses the 2e-5 contract (CPU emulation, tests).
//   * Layouts: a lane reads 16-byte runs of K and V rows from shared
//     memory; the k order of the scores follows them (the query fragments
//     are stored in that order), and P's k order (positions 2t, 2t + 1 at
//     t, t + 4) makes the scores' C fragment P's A fragment, no shuffle.
//     Row pitches are padded so that no fragment read hits a bank twice.
//   * One round trip before the first tile: the query rows, the row's
//     table entries and its length in flight at once (cp.async); each warp
//     then streams its tiles through its own two- or three-stage cp.async
//     ring, the pool row of each position handed between its lanes by
//     shuffles.  A tile past the range is neither copied nor computed.
//   * 8 warps a block; the warps' outputs and the block's merge in fragment
//     order (one store a register, no bank conflicts), merged in warp then
//     rank order as above.  The split count is the largest whose clusters
//     all run at once (kernel.py: split_count with the card's
//     cudaOccupancyMaxActiveClusters, flash_decode_wide_occupancy below):
//     a cluster that waits for a second wave doubles the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVals = 8;  // K/V values a lane holds of one row
constexpr int kMaxRep = 16;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kRowsMax = 512;  // positions whose pool rows are staged at once
constexpr float kNeg = -1e30f;

template <bool QUANT>
struct Chunk {
  using T = uint4;  // 8 bf16
};
template <>
struct Chunk<true> {
  using T = uint2;  // 8 int8
};

__device__ __forceinline__ void widen(const uint4 w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// int8 to fp32 exactly, without the slow I2F: byte b ^ 0x80 = b + 128 goes
// into the low mantissa bits of 2^23, and 2^23 + 128 is taken off again.
__device__ __forceinline__ void widen(const uint2 w, float* f) {
  const uint32_t u[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7440 | j)) -
          8388736.f;
}

// Copies `BYTES` from global to shared memory asynchronously; `n` = 0 of
// them read (the rest zero-filled) for a masked position.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The kernel's shape at (DH, rep, pool type).  A batch is the
// kDepth x kRowsPerLoad positions one warp takes at once, and a split's
// rounding unit (kernel.py: tile mirrors it); the warps of a block take a
// rank's batches in turn, a span at a time.  A ring stage holds one batch:
// each lane's K chunks, then its V chunks, then (int8) the batch's K and V
// scales.
template <int DH, int REP, bool QUANT>
struct Shape {
  static constexpr int kChunk = QUANT ? 8 : 16;  // bytes of 8 values
  static constexpr int kLanesPerRow = DH / kVals;
  static constexpr int kRowsPerLoad = 32 / kLanesPerRow;
  static constexpr int kDepth = REP > 4 ? 2 : 4;
  // a warp's ring: batches in flight + 1, some 8 KB in flight either way
  static constexpr int kStages = QUANT ? 5 : 3;
  static constexpr int kBatch = kDepth * kRowsPerLoad;
  static constexpr int kSpan = kWarps * kBatch;
  // A lane's kNv partial scores (heads padded to a power of two) become,
  // summed over the row's lanes, kHeld sums a lane, each shared by kShare
  // lanes, of kHeadsHeld heads.
  static constexpr int kRepPow =
      REP <= 1 ? 1 : REP <= 2 ? 2 : REP <= 4 ? 4 : REP <= 8 ? 8 : 16;
  static constexpr int kNv = kDepth * kRepPow;
  static constexpr int kHeld = kNv > kLanesPerRow ? kNv / kLanesPerRow : 1;
  static constexpr int kShare = kNv < kLanesPerRow ? kLanesPerRow / kNv : 1;
  static constexpr int kHeadsHeld = kHeld > kDepth ? kHeld / kDepth : 1;
  static constexpr int kLevels =  // log2(kLanesPerRow)
      kLanesPerRow == 16 ? 4 : kLanesPerRow == 8 ? 3 : kLanesPerRow == 4 ? 2 : 1;
  static constexpr int kKV = kDepth * 32 * kChunk;  // K (or V) of a stage
  static constexpr int kStage = 2 * kKV + (QUANT ? 2 * kBatch * 4 : 0);
  // A warp's share of the ring: its stages, and after the loop its acc
  // for the block's merge (the larger at rep 12 and 16).
  static constexpr int kWarpRing =
      kStages * kStage > REP * DH * 4 ? kStages * kStage : REP * DH * 4;
  static constexpr int kRing = kWarps * kWarpRing;  // dynamic smem
  static_assert(kWarpRing % 16 == 0, "a warp's ring must stay 16-byte aligned");
};

// Starts one lane's copies of the batch at `base` into the ring stage at
// `dst`: its K and V chunks of each of the batch's positions, and (int8,
// the row's first lane) their scales.  `rows` holds the pool row of each
// position of the window [t0, hi).
template <int DH, int REP, bool QUANT>
__device__ __forceinline__ void issue(unsigned char* dst,
                                      const unsigned char* kp,
                                      const unsigned char* vp,
                                      const float* k_scale,
                                      const float* v_scale, const int* rows,
                                      int base, int t0, int hi, int lane) {
  using Sh = Shape<DH, REP, QUANT>;
  const int slot = lane / Sh::kLanesPerRow, c = lane % Sh::kLanesPerRow;
#pragma unroll
  for (int d = 0; d < Sh::kDepth; ++d) {
    const int pos = base + d * Sh::kRowsPerLoad + slot;
    const int row = pos < hi ? rows[pos - t0] : -1;
    const size_t at =
        row >= 0 ? ((size_t)row * Sh::kLanesPerRow + c) * Sh::kChunk : 0;
    const int n = row >= 0 ? Sh::kChunk : 0;
    cp_async<Sh::kChunk>(dst + (d * 32 + lane) * Sh::kChunk, kp + at, n);
    cp_async<Sh::kChunk>(dst + Sh::kKV + (d * 32 + lane) * Sh::kChunk,
                         vp + at, n);
    if (QUANT && c == 0) {
      float* sc = reinterpret_cast<float*>(dst + 2 * Sh::kKV);
      const int o = d * Sh::kRowsPerLoad + slot;
      const int rr = row >= 0 ? row : 0, nn = row >= 0 ? 4 : 0;
      cp_async<4>(sc + o, k_scale + rr, nn);
      cp_async<4>(sc + Sh::kBatch + o, v_scale + rr, nn);
    }
  }
}

template <int DH, int REP, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,        // [B, G, rep, DH]
                    const void* __restrict__ k_pool,    // [NBP, bs, G, DH]
                    const void* __restrict__ v_pool,    // [NBP, bs, G, DH]
                    const float* __restrict__ k_scale,  // [NBP, bs, G]
                    const float* __restrict__ v_scale,  // [NBP, bs, G]
                    const int* __restrict__ table,      // [B, W]
                    const int* __restrict__ kv_lens,    // [B]
                    float* __restrict__ out,            // [B, G, rep, DH]
                    int G, int nbp, int bs, int W) {
  using C = typename Chunk<QUANT>::T;
  using Sh = Shape<DH, REP, QUANT>;
  constexpr int kLanesPerRow = Sh::kLanesPerRow;
  constexpr int kRowsPerLoad = Sh::kRowsPerLoad;
  constexpr int kDepth = Sh::kDepth;
  constexpr int kBatch = Sh::kBatch;
  constexpr int kSpan = Sh::kSpan;
  constexpr int kChunk = Sh::kChunk;
  constexpr int kStages = Sh::kStages;
  constexpr int kRepPow = Sh::kRepPow, kNv = Sh::kNv, kHeld = Sh::kHeld;
  constexpr int kShare = Sh::kShare, kHeadsHeld = Sh::kHeadsHeld;
  constexpr int kLevels = Sh::kLevels;

  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int rows_s[kRowsMax];  // pool row of each position, or -1
  __shared__ float wm[kWarps][REP], wl[kWarps][REP];
  __shared__ float bm[REP], bl[REP];  // the block's merged state, read
  __shared__ float bacc[REP][DH];      // by its peers through DSMEM

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;  // the cluster spans the grid's x
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = lane / kLanesPerRow, c = lane % kLanesPerRow;
  unsigned char* own = ring + warp * Sh::kWarpRing;  // this warp's

  // This rank's positions [start, end) of the row's live window.
  const int len = max(0, min(kv_lens[b], W * bs));
  const long long share = len / splits + (len % splits != 0);
  const long long per = (share + kBatch - 1) / kBatch * kBatch;
  const int start = (int)min((long long)len, rank * per);
  const int end = (int)min((long long)len, start + per);

  float qr[REP][kVals];
  const float* qb = q + ((size_t)b * G + g) * REP * DH + c * kVals;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(qb + r * DH));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(qb + r * DH + 4));
    qr[r][0] = lo.x; qr[r][1] = lo.y; qr[r][2] = lo.z; qr[r][3] = lo.w;
    qr[r][4] = hi.x; qr[r][5] = hi.y; qr[r][6] = hi.z; qr[r][7] = hi.w;
  }
  float m[REP], l[REP], acc[REP][kVals];
  float mheld[kHeadsHeld];  // m of the heads whose scores this lane holds
#pragma unroll
  for (int k = 0; k < kHeadsHeld; ++k) mheld[k] = kNeg;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kVals; ++i) acc[r][i] = 0.f;
  }

  const unsigned char* kp = static_cast<const unsigned char*>(k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(v_pool);
  for (int t0 = start; t0 < end;) {
    const int hi = min(end, t0 + kRowsMax);
    __syncthreads();  // the previous window's readers are done
    for (int i = tid; i < hi - t0; i += kThreads) {
      const int pos = t0 + i, blk = pos / bs;
      const int id = table[(size_t)b * W + blk];
      rows_s[i] = (id >= 0 && id < nbp) ? (id * bs + pos - blk * bs) * G + g
                                        : -1;
    }
    __syncthreads();

    // Passes of the whole block (so that the loop, and every shuffle in
    // it, is uniform): in each, every warp takes the next batch; one past
    // the window is all masked.
    const int first = t0 + warp * kBatch;
    const int nb = (hi - t0 + kSpan - 1) / kSpan;
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < nb)
        issue<DH, REP, QUANT>(own + j * Sh::kStage, kp, vp, k_scale, v_scale,
                               rows_s, first + j * kSpan, t0, hi, lane);
      cp_async_commit();
    }
    for (int it = 0; it < nb; ++it) {
      __syncwarp();  // every lane is done with the stage refilled next
      const int next = it + kStages - 1;
      if (next < nb)
        issue<DH, REP, QUANT>(own + (next % kStages) * Sh::kStage, kp, vp,
                               k_scale, v_scale, rows_s, first + next * kSpan,
                               t0, hi, lane);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // batch `it` has landed
      __syncwarp();  // ... the scales one lane copied too
      const int base = first + it * kSpan;
      const unsigned char* src = own + (it % kStages) * Sh::kStage;
      const float* sc = reinterpret_cast<const float*>(src + 2 * Sh::kKV);

      // Partial scores of the batch's positions (d) against the query
      // heads (r), x[r * kDepth + d], heads past REP zero.
      float x[kNv];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        float kf[kVals];
        widen(*reinterpret_cast<const C*>(src + (d * 32 + lane) * kChunk), kf);
#pragma unroll
        for (int r = 0; r < kRepPow; ++r) {
          float a = 0.f;
          if (r < REP) {
#pragma unroll
            for (int i = 0; i < kVals; ++i) a = fmaf(qr[r][i], kf[i], a);
          }
          x[r * kDepth + d] = a;
        }
      }
      // Summed over the row's lanes, each lane keeping a share: at offset
      // o a lane keeps the half its bit o picks and adds its partner's sum
      // of that half.  After it, lane c holds the kHeld sums from
      // (c / kShare) * kHeld on.
      // (Every loop here has a constant trip count and every index is
      // constant once unrolled, and the halves are blended with a bit mask,
      // not a select: otherwise x goes to local memory.)
#pragma unroll
      for (int lvl = 0; lvl < kLevels; ++lvl) {
        const int o = kLanesPerRow >> (lvl + 1);
        const int half = (kNv >> lvl) / 2;  // 0 once one value is left
        const uint32_t up = (c & o) ? 0xffffffffu : 0u;
#pragma unroll
        for (int i = 0; i < kNv / 2; ++i) {
          if (i < half) {
            const uint32_t lo = __float_as_uint(x[i]);
            const uint32_t hi = __float_as_uint(x[half + i]);
            const float keep = __uint_as_float((lo & ~up) | (hi & up));
            const float send = __uint_as_float((hi & ~up) | (lo & up));
            x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        if (half == 0) x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
      }
      const int v0 = (c / kShare) * kHeld;  // the first value this lane holds
      float sh[kHeld];
      bool live[kHeld];
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        const int d = (v0 + j) % kDepth, r = (v0 + j) / kDepth;
        const int pos = base + d * kRowsPerLoad + slot;
        live[j] = r < REP && pos < hi && rows_s[pos - t0] >= 0;
        const float ksc = QUANT ? sc[d * kRowsPerLoad + slot] : 1.f;
        sh[j] = live[j] ? x[j] * ksc : kNeg;
      }
      // The batch's max of each head this lane holds, over the batch's
      // positions, then everywhere: the state's rescaling.
      float mbh[kHeadsHeld];
#pragma unroll
      for (int k = 0; k < kHeadsHeld; ++k) {
        constexpr int kPer = kHeld < kDepth ? kHeld : kDepth;
        float mb = sh[k * kPer];
#pragma unroll
        for (int j = 1; j < kPer; ++j) mb = fmaxf(mb, sh[k * kPer + j]);
#pragma unroll
        for (int o = kShare; o < kShare * (kDepth / kPer); o <<= 1)
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
#pragma unroll
        for (int o = kLanesPerRow; o < 32; o <<= 1)
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
        mbh[k] = mb;
      }
      float corr[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int v = r * kDepth;
        const float mb = __shfl_sync(0xffffffffu, mbh[(v % kHeld) / kDepth],
                                     slot * kLanesPerRow + (v / kHeld) * kShare);
        const float mn = fmaxf(m[r], mb);
        corr[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      // Probabilities where the scores are, then everywhere.
      float ph[kHeld];
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        constexpr int kPer = kHeld < kDepth ? kHeld : kDepth;
        const float mh = fmaxf(mheld[j / kPer], mbh[j / kPer]);
        ph[j] = live[j] ? expf(sh[j] - mh) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kHeadsHeld; ++k)
        mheld[k] = fmaxf(mheld[k], mbh[k]);
      float p[REP][kDepth];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const int v = r * kDepth + d;
          p[r][d] = __shfl_sync(0xffffffffu, ph[v % kHeld],
                                slot * kLanesPerRow + (v / kHeld) * kShare);
        }
        float sum = l[r] * corr[r];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) sum += p[r][d];
        l[r] = sum;
#pragma unroll
        for (int i = 0; i < kVals; ++i) acc[r][i] *= corr[r];
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        float vf[kVals];
        widen(*reinterpret_cast<const C*>(src + Sh::kKV +
                                          (d * 32 + lane) * kChunk), vf);
        const float vsc = QUANT ? sc[Sh::kBatch + d * kRowsPerLoad + slot]
                                : 1.f;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float pv = QUANT ? p[r][d] * vsc : p[r][d];
#pragma unroll
          for (int i = 0; i < kVals; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i]);
        }
      }
    }
    t0 = hi;
  }
  cp_async_wait<0>();  // only empty groups are left; the ring is free
  __syncwarp();

  // The warp's state summed over its row slots (m is the same in every
  // lane), then left in shared memory: acc in the warp's own ring.
  float* wacc = reinterpret_cast<float*>(own);  // [REP][DH]
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int i = 0; i < kVals; ++i)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
    }
    if (slot == 0) {
      float4* dst = reinterpret_cast<float4*>(wacc + r * DH + c * kVals);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
  }
  __syncthreads();
  // Warps merged in warp order: the block's (m, l, acc).
  for (int idx = tid; idx < REP * DH; idx += kThreads) {
    const int r = idx / DH;
    float mx = wm[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wm[w][r]);
    float sl = 0.f, sa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w][r] - mx);
      const float* wa =
          reinterpret_cast<const float*>(ring + w * Sh::kWarpRing);
      sl = fmaf(wl[w][r], e, sl);
      sa = fmaf(wa[idx], e, sa);
    }
    bacc[r][idx - r * DH] = sa;
    if (idx == r * DH) {
      bm[r] = mx;
      bl[r] = sl;
    }
  }
  cluster.sync();
  // Each rank merges a slice of the row's outputs over the cluster's
  // blocks, in rank order, and writes it.
  const int n_out = REP * DH, slice = (n_out + splits - 1) / splits;
  float* ob = out + ((size_t)b * G + g) * n_out;
  for (int idx = rank * slice + tid; idx < min(n_out, (rank + 1) * slice);
       idx += kThreads) {
    const int r = idx / DH;
    float mj[kMaxSplits], lj[kMaxSplits], aj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      mj[j] = kNeg;
      lj[j] = aj[j] = 0.f;
      if (j < splits) {
        mj[j] = cluster.map_shared_rank(&bm[0], j)[r];
        lj[j] = cluster.map_shared_rank(&bl[0], j)[r];
        aj[j] = cluster.map_shared_rank(&bacc[0][0], j)[idx];
      }
    }
    float mx = mj[0];
#pragma unroll
    for (int j = 1; j < kMaxSplits; ++j) mx = fmaxf(mx, mj[j]);
    float sl = 0.f, sa = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < splits) {
        const float e = expf(mj[j] - mx);
        sl = fmaf(lj[j], e, sl);
        sa = fmaf(aj[j], e, sa);
      }
    }
    ob[idx] = sa / fmaxf(sl, 1e-30f);
  }
  cluster.sync();  // no block exits while a peer reads its shared memory
}

template <int DH, int REP, bool QUANT>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* lens, float* out,
           int B, int G, int nbp, int bs, int W, int splits,
           cudaStream_t stream) {
  constexpr int kRing = Shape<DH, REP, QUANT>::kRing;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_decode_kernel<DH, REP, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, G, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kRing;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<DH, REP, QUANT>, q, k, v, ks, vs, table,
      lens, out, G, nbp, bs, W);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide GQA groups, 9-16 query heads per KV head: the tensor cores.

constexpr int kWideMinRep = 9;
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideTile = 8;  // positions a warp takes at once: one n-tile
constexpr int kWideTab = 256;  // table entries a block holds at once

// x rounded to the nearest TF32 (ties away from zero), as fp32 bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b, one m16n8k8 TF32 product with fp32 sums.  A (16 x 8): a0 at
// (lane / 4, lane % 4), a1 8 rows below, a2 and a3 4 columns right; B
// (8 x 8): b0 at (lane % 4, lane / 4), b1 4 rows below; D (16 x 8): d0, d1
// at (lane / 4, 2 (lane % 4) + {0, 1}), d2, d3 8 rows below.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N consecutive values of a K/V row in shared memory (bf16 or int8), kept
// as stored; value i widened to fp32 on use (exact, and exact in TF32: 8
// and 7 significant bits), as its bits.
template <int N, bool QUANT>
struct Vals {
  static constexpr int kBytes = N * (QUANT ? 1 : 2);
  uint32_t u[kBytes >= 4 ? kBytes / 4 : 1];

  __device__ __forceinline__ explicit Vals(const unsigned char* p) {
    if constexpr (kBytes == 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
    } else if constexpr (kBytes == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      u[0] = w.x; u[1] = w.y;
    } else if constexpr (kBytes == 4) {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      u[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ uint32_t operator[](int i) const {
    if constexpr (QUANT)  // as widen(uint2) above
      return __float_as_uint(
          __uint_as_float(__byte_perm(u[i / 4] ^ 0x80808080u, 0x4B000000u,
                                      0x7440 | (i % 4))) -
          8388736.f);
    else
      return i % 2 ? u[i / 2] & 0xffff0000u : u[i / 2] << 16;
  }
};

// The wide kernel's shape at (DH, pool type).  In the scores' k-steps a
// lane (g = lane / 4, t = lane % 4) reads kCW consecutive values of K row g
// at a time (kRK rounds a row): k-step j = i * kCW / 2 + s of round i takes
// d = 4 kCW i + kCW t + 2 s (+1 for the lower half of B), and the query
// fragments follow the same order.  In P.V a lane reads kCV consecutive
// values of V rows 2t and 2t + 1 (kRV rounds): n-tile nt = iv * kCV + sv
// holds output column kCV (8 iv + g) + sv in its slot g.  Row pitches are
// padded so that the fragment reads hit no bank twice.  A ring stage holds
// one tile: K rows, V rows, (int8) the k and v scales, the pool rows.
template <int DH, bool QUANT>
struct Wide {
  static constexpr int kEsz = QUANT ? 1 : 2;
  static constexpr int kRow = DH * kEsz;  // bytes of a K/V row
  static constexpr int kPitchK =
      kRow + (QUANT ? (kRow >= 64 ? 32 : 0) : (kRow % 128 == 0 ? 64 : 0));
  static constexpr int kPitchV = kRow + 16;
  static constexpr int kKS = DH / 8;  // k-steps of the scores
  static constexpr int kCW = DH / 4 < 8 ? DH / 4 : 8;
  static constexpr int kRK = DH / (4 * kCW);
  static constexpr int kNT = DH / 8;  // n-tiles of the output
  static constexpr int kCV = kNT < 8 ? kNT : 8;
  static constexpr int kRV = kNT / kCV;
  static constexpr int kSpan = kWideWarps * kWideTile;
  static constexpr int kStages = QUANT ? 3 : 2;
  static constexpr int kKBytes = kWideTile * kPitchK;
  static constexpr int kVBytes = kWideTile * kPitchV;
  static constexpr int kScales = kKBytes + kVBytes;  // float [2][kWideTile]
  static constexpr int kRows = kScales + (QUANT ? 2 * kWideTile * 4 : 0);
  static constexpr int kStage = kRows + kWideTile * 4;
  // A warp's share of the ring: its stages, and after the loop its output
  // rows for the block's merge.
  static constexpr int kWarpRing = kStages * kStage > kMaxRep * DH * 4
                                       ? kStages * kStage
                                       : kMaxRep * DH * 4;
  // The query's TF32 fragments, high and low parts ([k-step][part][lane]
  // float4); after the loop the block's merged rows.
  static constexpr int kQBytes = kKS * 2 * 32 * 16;
  static constexpr int kSmem = kQBytes + kWideWarps * kWarpRing;
  static constexpr int kQPer = (kKS * 32 + kWideThreads - 1) / kWideThreads;
  static_assert(kStage % 16 == 0 && kWarpRing % 16 == 0, "16-byte stages");
  static_assert(kQBytes >= kMaxRep * DH * 4, "the merged rows fit");
};

// The pool row of live position `pos` (table entries from block `tw` on
// in `tab`), or -1 for a block id outside the pool.
__device__ __forceinline__ int pool_row(const int* tab, int tw, int pos,
                                        int bs, int G, int g, int nbp) {
  const int blk = pos / bs;
  const int id = tab[blk - tw];
  return (id >= 0 && id < nbp) ? (id * bs + pos - blk * bs) * G + g : -1;
}

// Starts one warp's copies of the tile at `base` into the ring stage at
// `dst`: the tile's K and V rows in 16-byte pieces, (int8) the scales, and
// the tile's pool rows (-1 past `hi` or masked), which lane p < 8 finds for
// position p and hands to the lanes copying it.
template <int DH, bool QUANT>
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const unsigned char* kp,
                                          const unsigned char* vp,
                                          const float* k_scale,
                                          const float* v_scale,
                                          const int* tab, int tw, int base,
                                          int hi, int bs, int G, int g,
                                          int nbp, int lane) {
  using Sh = Wide<DH, QUANT>;
  constexpr int kPer = Sh::kRow / 16;  // pieces of a row
  constexpr int kPieces = kWideTile * kPer;
  const int pos = base + lane % kWideTile;
  const int mine = pos < hi ? pool_row(tab, tw, pos, bs, G, g, nbp) : -1;
  if (lane < kWideTile) {
    reinterpret_cast<int*>(dst + Sh::kRows)[lane] = mine;
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(dst + Sh::kScales);
      const int rr = mine >= 0 ? mine : 0, nn = mine >= 0 ? 4 : 0;
      cp_async<4>(sc + lane, k_scale + rr, nn);
      cp_async<4>(sc + kWideTile + lane, v_scale + rr, nn);
    }
  }
#pragma unroll
  for (int k = 0; k < (kPieces + 31) / 32; ++k) {
    const int c = lane + 32 * k;
    const int p = (c / kPer) % kWideTile, part = c % kPer;
    const int row = __shfl_sync(0xffffffffu, mine, p);
    if (kPieces % 32 == 0 || c < kPieces) {
      const size_t at = row >= 0 ? (size_t)row * Sh::kRow + part * 16 : 0;
      const int n = row >= 0 ? 16 : 0;
      cp_async<16>(dst + p * Sh::kPitchK + part * 16, kp + at, n);
      cp_async<16>(dst + Sh::kKBytes + p * Sh::kPitchV + part * 16, vp + at,
                   n);
    }
  }
}

template <int DH, bool QUANT>
__global__ void __launch_bounds__(kWideThreads, 2)
flash_decode_wide_kernel(const float* __restrict__ q,        // [B, G, rep, DH]
                         const void* __restrict__ k_pool,    // [NBP, bs, G, DH]
                         const void* __restrict__ v_pool,    // [NBP, bs, G, DH]
                         const float* __restrict__ k_scale,  // [NBP, bs, G]
                         const float* __restrict__ v_scale,  // [NBP, bs, G]
                         const int* __restrict__ table,      // [B, W]
                         const int* __restrict__ kv_lens,    // [B]
                         float* __restrict__ out,            // [B, G, rep, DH]
                         int G, int rep, int nbp, int bs, int W) {
  using Sh = Wide<DH, QUANT>;
  constexpr int kCW = Sh::kCW, kCV = Sh::kCV, kNT = Sh::kNT;
  constexpr int kEsz = Sh::kEsz, kStages = Sh::kStages;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tab_s[kWideTab];  // the row's table, from entry tw on
  __shared__ float wm[kWideWarps][kMaxRep], wl[kWideWarps][kMaxRep];
  __shared__ float bm[kMaxRep], bl[kMaxRep];  // read by peers through DSMEM
  __shared__ float rw[kMaxSplits][kMaxRep], rl[kMaxRep];  // ranks' weights
  float4* qs = reinterpret_cast<float4*>(smem);  // [kKS][2][32]
  // after the loop, the block's merged output fragments [kNT][4][32]
  float* bacc = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + Sh::kQBytes;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the lane's fragment row, column
  unsigned char* own = ring + warp * Sh::kWarpRing;

  // One round trip before the first tile: the query rows (into the ring,
  // free until then), the row's first table entries and its length, all in
  // flight at once.
  float* qraw = reinterpret_cast<float*>(ring);  // [rep][DH]
  const float* qb = q + ((size_t)b * G + g) * rep * DH;
  for (int i = tid; i < rep * DH; i += kWideThreads)
    cp_async<4>(qraw + i, qb + i, 4);
  for (int i = tid; i < min(W, kWideTab); i += kWideThreads)
    cp_async<4>(tab_s + i, table + (size_t)b * W + i, 4);
  cp_async_commit();
  const int len = max(0, min(kv_lens[b], W * bs));
  const long long share = len / splits + (len % splits != 0);
  const long long per = (share + kWideTile - 1) / kWideTile * kWideTile;
  const int start = (int)min((long long)len, rank * per);
  const int end = (int)min((long long)len, start + per);
  cp_async_wait<0>();
  __syncthreads();
  // The query heads (rows past rep zero) as TF32 high and low parts, in
  // the fragment order of the scores' k-steps.
#pragma unroll
  for (int k = 0; k < Sh::kQPer; ++k) {
    const int idx = tid + k * kWideThreads;
    if (idx < Sh::kKS * 32) {
      const int j = idx / 32, ln = idx % 32, r = ln >> 2, c = ln & 3;
      const int d = 4 * kCW * (j / (kCW / 2)) + kCW * c + 2 * (j % (kCW / 2));
      const float a[4] = {r < rep ? qraw[r * DH + d] : 0.f,
                          r + 8 < rep ? qraw[(r + 8) * DH + d] : 0.f,
                          r < rep ? qraw[r * DH + d + 1] : 0.f,
                          r + 8 < rep ? qraw[(r + 8) * DH + d + 1] : 0.f};
      float hi4[4], lo4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi4[e] = __uint_as_float(tf32(a[e]));
        lo4[e] = __uint_as_float(tf32(a[e] - hi4[e]));
      }
      qs[(2 * j) * 32 + ln] = make_float4(hi4[0], hi4[1], hi4[2], hi4[3]);
      qs[(2 * j + 1) * 32 + ln] = make_float4(lo4[0], lo4[1], lo4[2], lo4[3]);
    }
  }
  __syncthreads();  // the fragments are in place, the ring is free

  // The lane's state: rows gq and gq + 8 of (m, l) (l its own positions'
  // share), and its fragments of the output rows.
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  const unsigned char* kp = static_cast<const unsigned char*>(k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(v_pool);
  int tw = 0;  // the table entry tab_s starts at
  for (int t0 = start; t0 < end;) {
    if (t0 / bs >= tw + kWideTab) {  // past the entries held: the next ones
      __syncthreads();
      tw = t0 / bs;
      for (int i = tid; i < min(W - tw, kWideTab); i += kWideThreads)
        tab_s[i] = table[(size_t)b * W + tw + i];
      __syncthreads();
    }
    // min(end, (tw + kWideTab) * bs), in int: the product only when it
    // is at most end
    const int hi = end / bs >= tw + kWideTab ? (tw + kWideTab) * bs : end;

    // Passes of the whole block (the loop, and every shuffle and product in
    // it, uniform): in each, every warp takes the next tile; one past the
    // window is all masked.
    const int first = t0 + warp * kWideTile;
    const int nb = (hi - t0 + Sh::kSpan - 1) / Sh::kSpan;
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (first + j * Sh::kSpan < hi)
        copy_tile<DH, QUANT>(own + j * Sh::kStage, kp, vp, k_scale, v_scale,
                             tab_s, tw, first + j * Sh::kSpan, hi, bs, G, g,
                             nbp, lane);
      cp_async_commit();
    }
    for (int it = 0; it < nb; ++it) {
      __syncwarp();  // every lane is done with the stage refilled next
      const int next = it + kStages - 1;
      if (first + next * Sh::kSpan < hi)
        copy_tile<DH, QUANT>(own + (next % kStages) * Sh::kStage, kp, vp,
                             k_scale, v_scale, tab_s, tw,
                             first + next * Sh::kSpan, hi, bs, G, g, nbp,
                             lane);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // tile `it` has landed
      __syncwarp();  // ... and its rows, which other lanes wrote
      if (first + it * Sh::kSpan >= hi) continue;  // past the window: empty
      const unsigned char* ks = own + (it % kStages) * Sh::kStage;
      const unsigned char* vs = ks + Sh::kKBytes;
      const float* sc = reinterpret_cast<const float*>(ks + Sh::kScales);
      const int* rows = reinterpret_cast<const int*>(ks + Sh::kRows);

      // Scores of heads (gq, gq + 8) x positions (2 tq, 2 tq + 1): q.K as
      // q_hi.K + q_lo.K, K exact in TF32.  Two chains of products (even and
      // odd k-steps), summed at the end: one chain would wait on each
      // product's latency in turn.
      float sa[2][4] = {};
#pragma unroll
      for (int i = 0; i < Sh::kRK; ++i) {
        const Vals<kCW, QUANT> kv(
            ks + gq * Sh::kPitchK + (4 * kCW * i + kCW * tq) * kEsz);
#pragma unroll
        for (int e = 0; e < kCW / 2; ++e) {
          const int j = i * (kCW / 2) + e;
          const float4 h = qs[(2 * j) * 32 + lane];
          const float4 w = qs[(2 * j + 1) * 32 + lane];
          const uint32_t ah[4] = {__float_as_uint(h.x), __float_as_uint(h.y),
                                  __float_as_uint(h.z), __float_as_uint(h.w)};
          const uint32_t al[4] = {__float_as_uint(w.x), __float_as_uint(w.y),
                                  __float_as_uint(w.z), __float_as_uint(w.w)};
          const uint32_t b0 = kv[2 * e], b1 = kv[2 * e + 1];
          mma_tf32(sa[j % 2], ah, b0, b1);
          mma_tf32(sa[j % 2], al, b0, b1);
        }
      }
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = sa[0][e] + sa[1][e];
      const bool live0 = rows[2 * tq] >= 0, live1 = rows[2 * tq + 1] >= 0;
      const float k0 = QUANT ? sc[2 * tq] : 1.f;
      const float k1 = QUANT ? sc[2 * tq + 1] : 1.f;
      const float x00 = live0 ? s[0] * k0 : kNeg, x01 = live1 ? s[1] * k1 : kNeg;
      const float x10 = live0 ? s[2] * k0 : kNeg, x11 = live1 ? s[3] * k1 : kNeg;
      // Online softmax on the fragments: a row's max over its quad.
      float mx0 = fmaxf(x00, x01), mx1 = fmaxf(x10, x11);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float p[4] = {live0 ? expf(x00 - mn0) : 0.f, live1 ? expf(x01 - mn0) : 0.f,
                    live0 ? expf(x10 - mn1) : 0.f, live1 ? expf(x11 - mn1) : 0.f};
      l0 = fmaf(l0, c0, p[0] + p[1]);
      l1 = fmaf(l1, c1, p[2] + p[3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        o[nt][0] *= c0;
        o[nt][1] *= c0;
        o[nt][2] *= c1;
        o[nt][3] *= c1;
      }
      if (QUANT) {  // the v scale on P's columns
        const float v0 = sc[kWideTile + 2 * tq], v1 = sc[kWideTile + 2 * tq + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      // P in the A layout: the k order (2t, 2t + 1 at t, t + 4) makes the C
      // fragment the A fragment, and V's rows follow it.
      const float pa[4] = {p[0], p[2], p[1], p[3]};
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[e] = tf32(pa[e]);
        pl[e] = tf32(pa[e] - __uint_as_float(ph[e]));
      }
#pragma unroll
      for (int iv = 0; iv < Sh::kRV; ++iv) {
        const int col = kCV * (8 * iv + gq) * kEsz;
        const Vals<kCV, QUANT> v0(vs + (2 * tq) * Sh::kPitchV + col);
        const Vals<kCV, QUANT> v1(vs + (2 * tq + 1) * Sh::kPitchV + col);
#pragma unroll
        for (int e = 0; e < kCV; ++e) {
          const int nt = iv * kCV + e;
          mma_tf32(o[nt], ph, v0[e], v1[e]);
          mma_tf32(o[nt], pl, v0[e], v1[e]);
        }
      }
    }
    t0 = hi;
  }
  cp_async_wait<0>();  // only empty groups are left; the ring is free
  __syncwarp();

  // The warp's state (l summed over the quad), then left in shared memory:
  // output rows in the warp's own ring.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // In fragment order, [kNT][4][32]: a store a register, no bank twice.
  float* wacc = reinterpret_cast<float*>(own);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[(nt * 4 + e) * 32 + lane] = o[nt][e];
  if (tq == 0) {
    wm[warp][gq] = m0;
    wl[warp][gq] = l0;
    wm[warp][gq + 8] = m1;
    wl[warp][gq + 8] = l1;
  }
  __syncthreads();
  // Warps merged in warp order: the block's (m, l, acc), acc over the
  // query's fragments, which no warp reads any more.  Each row's weights
  // first, a thread a row.
  if (tid < rep) {
    float mx = wm[0][tid];
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) mx = fmaxf(mx, wm[w][tid]);
    float sl = 0.f;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) {
      const float e = expf(wm[w][tid] - mx);
      sl = fmaf(wl[w][tid], e, sl);
      wm[w][tid] = e;  // from here on the warp's weight in the row
    }
    bm[tid] = mx;
    bl[tid] = sl;
  }
  __syncthreads();
  // A fragment slot f holds row frag_row(f) (rows past rep are skipped).
  constexpr int kSlots = kNT * 4 * 32;
  auto frag_row = [](int f) { return ((f & 31) >> 2) + ((f >> 6) & 1) * 8; };
  for (int f = tid; f < kSlots; f += kWideThreads) {
    const int r = frag_row(f);
    if (r < rep) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWideWarps; ++w) {
        const float* wa =
            reinterpret_cast<const float*>(ring + w * Sh::kWarpRing);
        acc = fmaf(wa[f], wm[w][r], acc);
      }
      bacc[f] = acc;
    }
  }
  cluster.sync();
  // Each rank merges a slice of the slots over the cluster's blocks, in
  // rank order, and writes their outputs: slot f = (nt * 4 + e) * 32 + lane
  // is row frag_row(f), column kCV (8 iv + 2 t + e % 2) + nt % kCV.  Each
  // row's weights first (a thread a row), then kBatch slots a thread with
  // all their peers' values in flight at once.
  if (tid < rep) {
    float mj[kMaxSplits], lj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      mj[j] = kNeg;
      lj[j] = 0.f;
      if (j < splits) {
        mj[j] = cluster.map_shared_rank(&bm[0], j)[tid];
        lj[j] = cluster.map_shared_rank(&bl[0], j)[tid];
      }
    }
    float mx = mj[0];
#pragma unroll
    for (int j = 1; j < kMaxSplits; ++j) mx = fmaxf(mx, mj[j]);
    float sl = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      const float e = j < splits ? expf(mj[j] - mx) : 0.f;
      sl = fmaf(lj[j], e, sl);
      rw[j][tid] = e;
    }
    rl[tid] = fmaxf(sl, 1e-30f);
  }
  __syncthreads();
  constexpr int kBatch = 4;
  const int slice = (kSlots + splits - 1) / splits;
  const int f_end = min(kSlots, (rank + 1) * slice);
  float* ob = out + ((size_t)b * G + g) * rep * DH;
  for (int f0 = rank * slice + tid; f0 < f_end;
       f0 += kBatch * kWideThreads) {
    float aj[kBatch][kMaxSplits];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int f = f0 + k * kWideThreads;
      const bool use = f < f_end && frag_row(f) < rep;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)
        aj[k][j] = use && j < splits ? cluster.map_shared_rank(bacc, j)[f]
                                     : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int f = f0 + k * kWideThreads, r = frag_row(f);
      if (f < f_end && r < rep) {
        float sa = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxSplits; ++j)
          if (j < splits) sa = fmaf(aj[k][j], rw[j][r], sa);
        const int nt = f >> 7, e = (f >> 5) & 3, t = f & 3;
        const int col =
            kCV * (8 * (nt / kCV) + 2 * t + (e & 1)) + nt % kCV;
        ob[r * DH + col] = sa / rl[r];
      }
    }
  }
  cluster.sync();  // no block exits while a peer reads its shared memory
}

// The wide kernel's launch shape: its dynamic shared memory allowed, all of
// the SM's 228 KB as shared memory (two blocks of ~95 KB at dh 128), and a
// grid (splits, G, B) in clusters of `splits`.
template <int DH, bool QUANT>
cudaError_t wide_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                        int splits, int G, int B) {
  constexpr int kSmem = Wide<DH, QUANT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_wide_kernel<DH, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_decode_wide_kernel<DH, QUANT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(splits, G, B);
  cfg->blockDim = dim3(kWideThreads);
  cfg->dynamicSmemBytes = kSmem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <int DH, bool QUANT>
int wide_occupancy(int splits, int* blocks_per_sm, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wide_config<DH, QUANT>(&cfg, &attr, splits, 1, 1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_decode_wide_kernel<DH, QUANT>, kWideThreads,
        cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, flash_decode_wide_kernel<DH, QUANT>, &cfg);
}

template <int DH, bool QUANT>
int launch_wide(const float* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* table, const int* lens, float* out,
                int B, int G, int rep, int nbp, int bs, int W, int splits,
                cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wide_config<DH, QUANT>(&cfg, &attr, splits, G, B);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, flash_decode_wide_kernel<DH, QUANT>, q, k, v,
                           ks, vs, table, lens, out, G, rep, nbp, bs, W);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DH, bool QUANT>
int launch_rep(const float* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* table, const int* lens, float* out,
               int B, int G, int rep, int nbp, int bs, int W, int splits,
               cudaStream_t s) {
#define FD_REP(R)                                                            \
  case R:                                                                    \
    return launch<DH, R, QUANT>(q, k, v, ks, vs, table, lens, out, B, G, nbp, \
                                bs, W, splits, s);
  switch (rep) {
    FD_REP(1) FD_REP(2) FD_REP(3) FD_REP(4)
    FD_REP(5) FD_REP(6) FD_REP(7) FD_REP(8)
    default:
      if (rep >= kWideMinRep && rep <= kMaxRep)
        return launch_wide<DH, QUANT>(q, k, v, ks, vs, table, lens, out, B, G,
                                      rep, nbp, bs, W, splits, s);
      return (int)cudaErrorInvalidValue;
  }
#undef FD_REP
}

template <int DH>
int launch_dh(const float* q, const void* k, const void* v, const float* ks,
              const float* vs, const int* table, const int* lens, float* out,
              int B, int G, int rep, int nbp, int bs, int W, int splits,
              bool quant, cudaStream_t s) {
  if (quant)
    return launch_rep<DH, true>(q, k, v, ks, vs, table, lens, out, B, G, rep,
                                nbp, bs, W, splits, s);
  return launch_rep<DH, false>(q, k, v, ks, vs, table, lens, out, B, G, rep,
                               nbp, bs, W, splits, s);
}

}  // namespace

extern "C" {

// Launches one flash_decode on `stream`: a grid of (splits, G, B) blocks in
// clusters of `splits`.  dh is 16, 32, 64 or 128; rep 1..16 (1..8 on the
// CUDA cores, 9..16 on the tensor cores); splits 1..8;
// the pools 16-byte aligned; k_scale / v_scale are read only when
// quant != 0.  nbp is the number of physical blocks: a table id outside
// [0, nbp) is masked like a position past kv_lens, never read.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel lacks.
int flash_decode_launch(const float* q, const void* k_pool,
                        const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* table,
                        const int* kv_lens, float* out, int B, int G, int rep,
                        int nbp, int bs, int W, int dh, int quant, int splits,
                        void* stream) {
  if (rep < 1 || rep > kMaxRep || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool qt = quant != 0;
  switch (dh) {
    case 16:
      return launch_dh<16>(q, k_pool, v_pool, k_scale, v_scale, table,
                           kv_lens, out, B, G, rep, nbp, bs, W, splits, qt, s);
    case 32:
      return launch_dh<32>(q, k_pool, v_pool, k_scale, v_scale, table,
                           kv_lens, out, B, G, rep, nbp, bs, W, splits, qt, s);
    case 64:
      return launch_dh<64>(q, k_pool, v_pool, k_scale, v_scale, table,
                           kv_lens, out, B, G, rep, nbp, bs, W, splits, qt, s);
    case 128:
      return launch_dh<128>(q, k_pool, v_pool, k_scale, v_scale, table,
                            kv_lens, out, B, G, rep, nbp, bs, W, splits, qt,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the tensor-core kernel (rep 9..16) an SM holds, and clusters of
// `splits` blocks the card holds at once, at (dh, quant): what bounds a
// grid's first wave.  Returns a CUDA error code (0 on success).
int flash_decode_wide_occupancy(int dh, int quant, int splits,
                                int* blocks_per_sm, int* clusters) {
  const bool qt = quant != 0;
  switch (dh) {
    case 16:
      return qt ? wide_occupancy<16, true>(splits, blocks_per_sm, clusters)
                : wide_occupancy<16, false>(splits, blocks_per_sm, clusters);
    case 32:
      return qt ? wide_occupancy<32, true>(splits, blocks_per_sm, clusters)
                : wide_occupancy<32, false>(splits, blocks_per_sm, clusters);
    case 64:
      return qt ? wide_occupancy<64, true>(splits, blocks_per_sm, clusters)
                : wide_occupancy<64, false>(splits, blocks_per_sm, clusters);
    case 128:
      return qt ? wide_occupancy<128, true>(splits, blocks_per_sm, clusters)
                : wide_occupancy<128, false>(splits, blocks_per_sm, clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
