// Paged decode attention over a block table, online softmax, written for
// Hopper (sm_90a), fp32 on the CUDA cores.
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
    FD_REP(12) FD_REP(16)
    default:
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
// clusters of `splits`.  dh is 16, 32, 64 or 128; rep 1..8, 12 or 16 (the
// wrapper pads another rep up to 16 with zero query heads); splits 1..8;
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

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
