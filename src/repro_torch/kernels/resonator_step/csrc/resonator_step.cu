// Fused resonator sweep for the bipolar (MAP) algebra, written for Hopper
// (sm_90a), plain fp32 on the CUDA cores.
//
// Replaces the TPU kernels in src/repro/kernels/resonator_step/kernel.py:
//   resonator_step_batch         (dense;  no mask)
//   resonator_step_batch_masked  (masked; a validity mask [F, M])
//   resonator_step_batch_local   (one model shard's rows; masked, LOCAL)
// For every (row n, factor f):
//   u      = q[n] * prod_g est[n, g] * est[n, f]         (unbind, est = +-1)
//   alpha  = u . X[f, m]            for m < M            (scores)
//   alpha  = -1e9 where mask[f, m] <= 0                  (masked only)
//   w      = alpha or |alpha|  (use_abs), times mask     (activation)
//   est'   = sign(w . X[f]) with sign(0) = +1            (projection)
// LOCAL: X is one model shard's row block [F, M_loc, D] and the mask its
// slice.  alpha is written RAW (the -1e9 applies to the weights only) and
// est' is the fp32 partial projection w . X[f], not its sign: the caller
// sums every shard's (zero-padded scores, partial projection) and
// saturates the sum (core/factorizer.py, model-sharded mode).
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): at the engine's
// shape (N = 256 rows, F = 3, M = 10, D = 2048) one sweep must read q (2.1 MB),
// est (6.3 MB) and the codebooks (0.25 MB) and write est' (6.3 MB) and alpha:
// about 15 MB, 4.5 us at the memory rate, against 63 MFLOP, about 0.9 us at
// the fp32 rate.  LOCAL at the sharded serving shape (64 rows a shard, F = 3,
// M_loc = 5): about 3.8 MB, 1.1 us.  Both are bound by bytes, so tensor
// cores (wgmma) are not the lever; nor could they keep the exactness below.
//
// Design: all F factors of a tile of R rows are one thread-block cluster of
// C blocks (C <= 8, the portable size), and block `rank` owns the slice
// [rank * Ds, (rank + 1) * Ds) of D.  So q and est cross device memory once
// a sweep and the all-factor product is formed once per element.
//   1. Staging: the block copies the slice of every factor's codebook
//      X[:, :, slice] into shared memory with 16-byte cp.async, and, while
//      those are in flight, loads its rows' q and est with 16-byte loads
//      (4-byte where D % 4 != 0 or a pointer is unaligned), forms u in
//      registers and stores only u.
//   2. Scores: a warp takes a (factor, tile of MT <= 8 codebook rows, group
//      of up to 4 rows) unit and runs its lanes along the slice, up to 32
//      sums in registers (M = 10 is two exact tiles of 5), reduced across
//      the lanes by a reduce-scatter (31 shuffles; lane l ends holding sum
//      l).  The slice's partial scores stay in shared memory.
//   3. Cluster reduction: every block sums the C ranks' partial scores,
//      all read through distributed shared memory at once and added in rank
//      order, applies mask and activation, and keeps the weights; the ranks
//      share the alpha stores.  The mask (bool or float) is read as it is,
//      its load in flight during the staging.
//   4. Projection: a thread takes (factor, 8 rows, 4 elements along D),
//      reads 4 codebook rows as float4 and each row's 4 weights as one
//      broadcast float4 per step, and stores est' with 16-byte stores.  The
//      codebook slice is still resident from the scores.
// Where a slice's tiles do not fit shared memory (large M or F, long D) the
// block walks its slice in chunks of Dc, and the projection stages each
// chunk's codebook again.  The launch attributes are set once per
// instantiation; registers are held to three blocks an SM so that every
// cluster of the engine's grid is resident at once.
//
// Exactness: on +-1 inputs every score and projection entry is an integer
// below 2^24, so fp32 FMA gives the plain version's result bit for bit in
// any summation order; so do the partial projections of LOCAL and their
// sum over shards.  No TF32 or bf16 path: the projection's weights are
// integers up to D, beyond what TF32 holds exactly for D > 2048.  Sums run
// in a fixed order (no atomics), so a launch's bits repeat on any input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;
constexpr int kProjRows = 8;  // rows a projection thread keeps
constexpr int kFReg = 4;  // factors whose est a staging thread keeps
constexpr int kSmemMax = 200 * 1024;  // dynamic shared memory opt-in
constexpr float kNeg = -1e9f;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Reduce-scatter of P sums across a warp: afterwards v[0] of lane l holds
// the warp's total of sum (l mod P).  Offset O halves the sums a lane keeps
// once P == 2 * O; before that every lane adds all P of its partner's.
template <int N, int P, int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (O >= 1) {
    if constexpr (P == 2 * O) {
      const bool hi = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const float keep = hi ? v[i + O] : v[i];
        const float send = hi ? v[i] : v[i + O];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<N, O, O / 2>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
      reduce_scatter<N, P, O / 2>(v, lane);
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

struct Params {
  const float* q;      // [N, D]
  const float* est;    // [N, F, D]
  const float* cb;     // [F, M, D]
  const void* mask;    // [F, M] bool / uint8 (a byte) or float32, or null
  float* alpha;        // [N, F, M]
  float* new_est;      // [N, F, D]; LOCAL: the fp32 partial projection
  int N, F, M, D;
  int rows;            // R: rows of a cluster's tile
  int ds;              // D slice of a rank, a multiple of 4
  int dc;              // chunk of the slice staged at once, a multiple of 4
  int mask_bool, use_abs, local, vec;
};

// Entry i of the mask: 1 where it is nonzero (a valid row, as the plain
// version's cast to bool reads it), else 0.
__device__ __forceinline__ float mask_at(const Params& p, int i) {
  const bool valid = p.mask_bool
      ? static_cast<const unsigned char*>(p.mask)[i] != 0
      : static_cast<const float*>(p.mask)[i] != 0.f;
  return valid ? 1.f : 0.f;
}

// Copies floats 4 * p4 .. 4 * p4 + 3 of a row piece of `len` floats from
// global `src` into shared `dst`: one 16-byte cp.async where `vec`, else
// 4-byte ones, the places at or past `len` set to zero.
__device__ __forceinline__ void stage_piece(float* dst, const float* src,
                                            int p4, int len, bool vec) {
  if (vec) {
    cp_async<16>(dst + 4 * p4, src + 4 * p4);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * p4 + e;
      if (d < len) cp_async<4>(dst + d, src + d);
      else dst[d] = 0.f;
    }
  }
}

// Stages the chunk [d0, d0 + len) of every factor's codebook rows into xs
// [F][M][dc] with cp.async: a warp copies one row at a time, its lanes
// along the row.
__device__ __forceinline__ void stage_codebook(const Params& p, float* xs,
                                               int d0, int len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = (len + 3) >> 2;
  for (int row = warp; row < p.F * p.M; row += kWarps)
    for (int p4 = lane; p4 < nv; p4 += 32)
      stage_piece(xs + (size_t)row * p.dc, p.cb + (size_t)row * p.D + d0, p4,
                  len, p.vec);
}

// Floats 4 * p4 .. 4 * p4 + 3 of a row piece of `len` floats, zero at or
// past `len`: one 16-byte load where `vec`.
__device__ __forceinline__ float4 load4(const float* src, int p4, int len,
                                        bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(src) + p4);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = 4 * p4 + e < len ? __ldg(src + 4 * p4 + e) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// u[r, f] = (q * prod_g est[r, g]) * est[r, f] over the chunk [d0, d0 +
// len), rounded as the plain version rounds it, into us [R][F][dc]: a
// thread loads a row's q and est at 4 places (est of the first kFReg
// factors kept in registers, of later ones read again) and stores u.  Rows
// past N take row N - 1.
__device__ __forceinline__ void stage_unbound(const Params& p, float* us,
                                              int row0, int d0, int len) {
  const int F = p.F, nv = (len + 3) >> 2, st = p.dc >> 2;
  for (int i = threadIdx.x; i < p.rows * nv; i += kThreads) {
    const int r = i / nv, p4 = i - r * nv;
    const int n = min(row0 + r, p.N - 1);
    const float* er = p.est + (size_t)n * F * p.D + d0;
    const float4 qv = load4(p.q + (size_t)n * p.D + d0, p4, len, p.vec);
    float4 e[kFReg];
#pragma unroll
    for (int g = 0; g < kFReg; ++g)
      if (g < F) e[g] = load4(er + (size_t)g * p.D, p4, len, p.vec);
    float4 prod = e[0];
#pragma unroll
    for (int g = 1; g < kFReg; ++g)
      if (g < F) prod = mul4(prod, e[g]);
    for (int g = kFReg; g < F; ++g)
      prod = mul4(prod, load4(er + (size_t)g * p.D, p4, len, p.vec));
    const float4 qp = mul4(qv, prod);
    float4* ur = reinterpret_cast<float4*>(us + (size_t)r * F * p.dc) + p4;
#pragma unroll
    for (int g = 0; g < kFReg; ++g)
      if (g < F) ur[g * st] = mul4(qp, e[g]);
    for (int g = kFReg; g < F; ++g)
      ur[g * st] = mul4(qp, load4(er + (size_t)g * p.D, p4, len, p.vec));
  }
}

// The chunk's share of the scores, pt[r, f, m] (+)= sum_d u[r, f, d]
// X[f, m, d]: a warp takes a (factor, tile of MT codebook rows, group of
// rb rows) unit, its lanes along the chunk; `first` writes, else adds.
template <int MT>
__device__ __forceinline__ void scores(const float* xs, const float* us,
                                       float* pt, int R, int F, int M,
                                       int dc, int nv, bool first) {
  constexpr int RB = 4;  // most rows of a score unit
  constexpr int V = RB * MT, P = pow2_at_least(V);
  static_assert(V <= 32, "a unit's sums fit one warp's lanes");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rb = min(RB, R);  // rows of a unit; R and RB powers of 2
  const int mtiles = (M + MT - 1) / MT, rgroups = R / rb;
  const int units = F * mtiles * rgroups, st = dc >> 2;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4* us4 = reinterpret_cast<const float4*>(us);
  for (int u = warp; u < units; u += kWarps) {
    const int rg = u % rgroups, rest = u / rgroups;
    const int mt = rest % mtiles, f = rest / mtiles;
    const int r0 = rg * rb, mb = mt * MT;
    int xo[MT], uo[RB];  // float4 offsets of the unit's rows
#pragma unroll
    for (int k = 0; k < MT; ++k) xo[k] = (f * M + min(mb + k, M - 1)) * st;
#pragma unroll
    for (int r = 0; r < RB; ++r) uo[r] = (min(r0 + r, R - 1) * F + f) * st;
    float acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int p4 = lane; p4 < nv; p4 += 32) {
      float4 uv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < rb) uv[r] = us4[uo[r] + p4];
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        const float4 x = xs4[xo[k] + p4];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r >= rb) continue;  // uniform: the unit's rows
          float a = acc[r * MT + k];
          a = fmaf(uv[r].x, x.x, a);
          a = fmaf(uv[r].y, x.y, a);
          a = fmaf(uv[r].z, x.z, a);
          a = fmaf(uv[r].w, x.w, a);
          acc[r * MT + k] = a;
        }
      }
    }
    reduce_scatter<P, P, 16>(acc, lane);
    const int r = lane / MT, m = mb + lane % MT;
    if (lane < V && r < rb && m < M) {
      float* o = pt + ((r0 + r) * F + f) * M + m;
      *o = first ? acc[0] : *o + acc[0];
    }
  }
}

// est'[r, f, d] = sign(sum_m w[r, f, m] X[f, m, d]) over the chunk (LOCAL:
// the sum itself): a thread takes (factor, kProjRows rows, 4 elements),
// 4 codebook rows and each row's 4 weights (one broadcast float4) a step.
__device__ __forceinline__ void project(const Params& p, const float* xs,
                                        const float* wsm, int row0, int d0,
                                        int len) {
  const int F = p.F, M = p.M, R = p.rows, m4 = (M + 3) & ~3;
  const int nv = (len + 3) >> 2, st = p.dc >> 2;
  const int pgroups = (R + kProjRows - 1) / kProjRows;
  for (int i = threadIdx.x; i < F * pgroups * nv; i += kThreads) {
    const int p4 = i % nv, rest = i / nv;
    const int pg = rest % pgroups, f = rest / pgroups;
    const int r0 = pg * kProjRows, nr = min(kProjRows, R - r0);
    const float4* xf =
        reinterpret_cast<const float4*>(xs + (size_t)f * M * p.dc) + p4;
    float4 acc[kProjRows];
#pragma unroll
    for (int rr = 0; rr < kProjRows; ++rr) acc[rr] = make_float4(0, 0, 0, 0);
    int m = 0;
    for (; m + 4 <= M; m += 4) {
      const float4 x0 = xf[m * st], x1 = xf[(m + 1) * st],
                   x2 = xf[(m + 2) * st], x3 = xf[(m + 3) * st];
#pragma unroll
      for (int rr = 0; rr < kProjRows; ++rr) {
        if (rr < nr) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              wsm + ((r0 + rr) * F + f) * m4 + m);
          acc[rr] = fma4(w4.w, x3, fma4(w4.z, x2,
                         fma4(w4.y, x1, fma4(w4.x, x0, acc[rr]))));
        }
      }
    }
    for (; m < M; ++m) {
      const float4 x = xf[m * st];
#pragma unroll
      for (int rr = 0; rr < kProjRows; ++rr)
        if (rr < nr)
          acc[rr] = fma4(wsm[((r0 + rr) * F + f) * m4 + m], x, acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < kProjRows; ++rr) {
      const int n = row0 + r0 + rr;
      if (rr >= nr || n >= p.N) continue;
      float4 o = acc[rr];
      if (!p.local)
        o = make_float4(o.x >= 0.f ? 1.f : -1.f, o.y >= 0.f ? 1.f : -1.f,
                        o.z >= 0.f ? 1.f : -1.f, o.w >= 0.f ? 1.f : -1.f);
      float* dst = p.new_est + ((size_t)n * F + f) * p.D + d0 + 4 * p4;
      if (p.vec) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
        const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * p4 + e < len) dst[e] = ov[e];
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 3)  // three blocks an SM at least
resonator_step_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int F = p.F, M = p.M, D = p.D, R = p.rows, dc = p.dc;
  const int m4 = (M + 3) & ~3, rfm = R * F * M;
  float* xs = smem;                            // [F][M][dc]    codebook chunk
  float* in = xs + (size_t)F * M * dc;         // [R][F][dc]    u
  float* part = in + (size_t)R * F * dc;       // [R][F][M]     slice's scores
  float* wsm = part + ((rfm + 3) & ~3);        // [R][F][m4]    weights
  float* msk = wsm + R * F * m4;               // [F][M]        mask

  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / C) * R;
  const int s0 = min(rank * p.ds, D), s1 = min(s0 + p.ds, D);
  const int nchunks = s1 > s0 ? (s1 - s0 + dc - 1) / dc : 0;

  float mv = 0.f;  // this thread's mask entry, in flight during the staging
  if (p.mask != nullptr && tid < F * M) mv = mask_at(p, tid);
  if (nchunks == 0)  // an empty slice adds nothing to the cluster's scores
    for (int i = tid; i < rfm; i += kThreads) part[i] = 0.f;

  // ---- scores of the slice ------------------------------------------------
  for (int c = 0; c < nchunks; ++c) {
    const int d0 = s0 + c * dc, len = min(dc, s1 - d0);
    if (c > 0) __syncthreads();  // the previous chunk's readers are done
    stage_codebook(p, xs, d0, len);
    stage_unbound(p, in, row0, d0, len);
    cp_async_wait_all();
    __syncthreads();
    scores<MT>(xs, in, part, R, F, M, dc, (len + 3) >> 2, c == 0);
  }

  // ---- the cluster's sum, mask and activation -------------------------------
  if (p.mask != nullptr) {  // read after the barrier
    if (tid < F * M) msk[tid] = mv;
    for (int i = kThreads + tid; i < F * M; i += kThreads) msk[i] = mask_at(p, i);
  }
  cluster.sync();  // every rank's partial scores are complete and visible
  for (int i = tid; i < rfm; i += kThreads) {
    float v[kMaxCluster];  // the ranks' partial sums, all loads in flight
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      v[k] = k < C ? cluster.map_shared_rank(part, k)[i] : 0.f;
    float a = v[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < C) a += v[k];
    const int r = i / (F * M), fm = i - r * F * M, f = fm / M, m = fm - f * M;
    const int n = row0 + r;
    float mk = 1.f, am = a;
    if (p.mask != nullptr) {
      mk = msk[fm];
      if (!(mk > 0.f)) am = kNeg;
    }
    if (n < p.N && i % C == rank)
      p.alpha[((size_t)n * F + f) * M + m] = p.local ? a : am;
    float w = p.use_abs ? fabsf(am) : am;
    if (p.mask != nullptr) w *= mk;
    wsm[(r * F + f) * m4 + m] = w;
  }
  __syncthreads();

  // ---- projection: one chunk finds the codebook slice still resident --------
  for (int c = 0; c < nchunks; ++c) {
    const int d0 = s0 + c * dc, len = min(dc, s1 - d0);
    if (nchunks > 1) {
      __syncthreads();
      stage_codebook(p, xs, d0, len);
      cp_async_wait_all();
      __syncthreads();
    }
    project(p, xs, wsm, row0, d0, len);
  }
  cluster.sync();  // no block exits while a peer reads its shared memory
}

template <int MT>
int launch(const Params& p, int clusters, int csize, int smem,
           cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      resonator_step_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);  // once per instantiation
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, resonator_step_kernel<MT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

typedef int (*launch_fn)(const Params&, int, int, int, cudaStream_t);
const launch_fn kLaunch[8] = {launch<1>, launch<2>, launch<3>, launch<4>,
                               launch<5>, launch<6>, launch<7>, launch<8>};

}  // namespace

extern "C" {

// Launches one fused sweep on `stream`: `clusters` clusters of `csize`
// blocks, `rows` rows a cluster, slices of `ds` and chunks of `dc` floats
// (multiples of 4), `smem` bytes of dynamic shared memory, score tiles of
// `mt` (1..8) codebook rows.  `mask` null selects the dense variant, else
// the masked one (`mask_bool`: one byte an entry, else float32); `local`
// selects the model-shard variant (a null mask: every row valid), whose
// `new_est` receives the fp32 partial projection.  `vec` requires D % 4 ==
// 0 and 16-byte aligned pointers.  Returns the launch's CUDA error (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take.
int resonator_step_launch(const float* q, const float* est, const float* cb,
                          const void* mask, int mask_bool, float* alpha,
                          float* new_est, int N, int F, int M, int D,
                          int rows, int clusters, int csize, int ds, int dc,
                          int mt, int smem, int use_abs, int local, int vec,
                          void* stream) {
  if (mt < 1 || mt > 8 || csize < 1 || csize > kMaxCluster ||
      smem > kSmemMax || ds % 4 || dc % 4 || dc < 4)
    return (int)cudaErrorInvalidValue;
  const Params p = {q, est, cb, mask, alpha, new_est, N, F, M, D, rows, ds,
                    dc, mask_bool, use_abs, local, vec};
  return kLaunch[mt - 1](p, clusters, csize, smem,
                         static_cast<cudaStream_t>(stream));
}

const char* resonator_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
