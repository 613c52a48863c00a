// Fused resonator sweep for the bipolar (MAP) algebra, written for Hopper
// (sm_90a), plain fp32 on the CUDA cores.
//
// Replaces the TPU kernels in src/repro/kernels/resonator_step/kernel.py:
//   resonator_step_batch         (dense;  MASKED = false)
//   resonator_step_batch_masked  (masked; MASKED = true)
//   resonator_step_batch_local   (one model shard's rows; MASKED and LOCAL)
// For every (row n, factor f):
//   u      = q[n] * prod_g est[n, g] * est[n, f]         (unbind, est = +-1)
//   alpha  = u . X[f, m]            for m < M            (scores)
//   alpha  = -1e9 where mask[f, m] <= 0                  (MASKED only)
//   w      = alpha or |alpha|  (USE_ABS), times mask     (activation)
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
// about 15 MB, 4.5 us at the memory rate, against 63 MFLOP, about 1 us at
// the fp32 rate.  So it is bound by bytes.  What the design does about it:
// each input byte crosses device memory about once per factor block (the
// F blocks of one row tile read the same q and est lines, mostly from L2),
// the all-factor product is formed in registers and never written, the
// codebook chunk is staged once per block in shared memory and serves both
// the scores and the projection, and the scores never leave shared memory
// except as the alpha output.
//
// LOCAL at the sharded serving shape (64 rows a shard, F = 3, M_loc = 5,
// D = 2048): q (0.5 MB), est (1.6 MB), the block (0.12 MB) and the fp32
// projection (1.6 MB): about 3.8 MB, 1.1 us at the memory rate; bound by
// bytes as well.
//
// Exactness: on +-1 inputs every score and projection entry is an integer
// below 2^24, so fp32 FMA gives the plain version's result bit for bit in
// any summation order; so do the partial projections of LOCAL and their
// sum over shards.  No TF32 or bf16 path: the projection's weights are
// integers up to D, beyond what TF32 holds exactly for D > 2048.
//
// Geometry (chosen by the Python wrapper, kernel.py::launch_geometry):
// grid (ceil(N / rows), F), 256 threads.  `rows` is a power of two; the
// block stages X[f] in chunks of `dc` lanes along D.  Scores: each warp owns
// one (row, D-slice) unit and keeps 16 partial scores in registers, reduced
// by shuffles into shared memory in a fixed order.  Projection: threads run
// along D, so est' stores are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMTile = 16;  // partial scores a lane keeps in registers
constexpr float kNeg = -1e9f;

template <bool MASKED, bool USE_ABS, bool LOCAL>
__global__ void __launch_bounds__(kThreads)
resonator_step_kernel(const float* __restrict__ q,     // [N, D]
                      const float* __restrict__ est,   // [N, F, D]
                      const float* __restrict__ cb,    // [F, M, D]
                      const float* __restrict__ mask,  // [F, M] or null
                      float* __restrict__ alpha,       // [N, F, M]
                      float* __restrict__ new_est,     // [N, F, D]; LOCAL:
                                                       // the fp32 projection
                      int N, int F, int M, int D, int rows, int dc) {
  extern __shared__ float smem[];
  // rows is a power of two: below kWarps, wpr warps share one row's D range;
  // from kWarps up, each warp owns whole rows.  units = rows * wpr.
  const int wpr = rows < kWarps ? kWarps / rows : 1;
  const int units = rows * wpr;
  float* xs = smem;                          // [M][dc]     codebook chunk
  float* part = xs + (size_t)M * dc;         // [units][M]  partial scores
  float* ws = part + (size_t)units * M;      // [rows][M]   projection weights

  const int f = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cbf = cb + (size_t)f * M * D;
  const int nchunks = (D + dc - 1) / dc;

  for (int i = tid; i < units * M; i += kThreads) part[i] = 0.f;

  // ---- scores: alpha[r, m] = sum_d u[r, d] * X[f, m, d] -------------------
  for (int c = 0; c < nchunks; ++c) {
    const int d0 = c * dc, len = min(dc, D - d0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < M * len; i += kThreads) {
      const int m = i / len, dd = i - m * len;
      xs[m * dc + dd] = cbf[(size_t)m * D + d0 + dd];
    }
    __syncthreads();
    for (int u = warp; u < units; u += kWarps) {
      const int r = u / wpr, j = u - r * wpr, n = row0 + r;
      if (n >= N) continue;  // ragged last row tile (warp-uniform)
      const float* qn = q + (size_t)n * D;
      const float* en = est + (size_t)n * F * D;
      for (int mt = 0; mt < M; mt += kMTile) {
        float acc[kMTile];
#pragma unroll
        for (int k = 0; k < kMTile; ++k) acc[k] = 0.f;
        for (int dd = j * 32 + lane; dd < len; dd += wpr * 32) {
          const int d = d0 + dd;
          float prod = 1.f;
          for (int g = 0; g < F; ++g) prod *= en[(size_t)g * D + d];
          const float uv = qn[d] * prod * en[(size_t)f * D + d];
#pragma unroll
          for (int k = 0; k < kMTile; ++k)
            if (mt + k < M) acc[k] = fmaf(uv, xs[(mt + k) * dc + dd], acc[k]);
        }
#pragma unroll
        for (int k = 0; k < kMTile; ++k) {
          float v = acc[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0 && mt + k < M) part[u * M + mt + k] += v;
        }
      }
    }
  }
  __syncthreads();

  // ---- mask, activation, alpha out ----------------------------------------
  for (int i = tid; i < rows * M; i += kThreads) {
    const int r = i / M, m = i - r * M, n = row0 + r;
    float w = 0.f;
    if (n < N) {
      float a = 0.f;
      for (int j = 0; j < wpr; ++j) a += part[(r * wpr + j) * M + m];
      float mk = 1.f, am = a;
      if (MASKED) {
        mk = mask[f * M + m];
        if (!(mk > 0.f)) am = kNeg;
      }
      alpha[((size_t)n * F + f) * M + m] = LOCAL ? a : am;  // LOCAL: raw
      w = USE_ABS ? fabsf(am) : am;
      if (MASKED) w *= mk;
    }
    ws[i] = w;
  }
  __syncthreads();

  // ---- projection: est'[r, d] = sign(sum_m w[r, m] * X[f, m, d]) ----------
  // ---- (LOCAL: the sum itself) ---------------------------------------------
  for (int c = 0; c < nchunks; ++c) {
    const int d0 = c * dc, len = min(dc, D - d0);
    if (nchunks > 1) {  // one chunk: X[f] is still resident from the scores
      __syncthreads();
      for (int i = tid; i < M * len; i += kThreads) {
        const int m = i / len, dd = i - m * len;
        xs[m * dc + dd] = cbf[(size_t)m * D + d0 + dd];
      }
      __syncthreads();
    }
    for (int i = tid; i < rows * len; i += kThreads) {
      const int r = i / len, dd = i - r * len, n = row0 + r;
      if (n >= N) continue;
      const float* wr = ws + r * M;
      float proj = 0.f;
      for (int m = 0; m < M; ++m) proj = fmaf(wr[m], xs[m * dc + dd], proj);
      new_est[((size_t)n * F + f) * D + d0 + dd] =
          LOCAL ? proj : (proj >= 0.f ? 1.f : -1.f);
    }
  }
}

template <bool MASKED, bool USE_ABS, bool LOCAL>
int launch(const float* q, const float* est, const float* cb,
           const float* mask, float* alpha, float* new_est, int N, int F,
           int M, int D, int rows, int dc, cudaStream_t stream) {
  const int wpr = rows < kWarps ? kWarps / rows : 1;
  const size_t smem =
      sizeof(float) * ((size_t)M * dc + (size_t)(rows * wpr + rows) * M);
  auto kernel = resonator_step_kernel<MASKED, USE_ABS, LOCAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + rows - 1) / rows, F);
  kernel<<<grid, kThreads, smem, stream>>>(q, est, cb, mask, alpha, new_est,
                                           N, F, M, D, rows, dc);
  return (int)cudaGetLastError();
}

template <bool MASKED, bool LOCAL>
int launch_act(const float* q, const float* est, const float* cb,
               const float* mask, float* alpha, float* new_est, int N, int F,
               int M, int D, int rows, int dc, int use_abs,
               cudaStream_t stream) {
  return use_abs ? launch<MASKED, true, LOCAL>(q, est, cb, mask, alpha,
                                                new_est, N, F, M, D, rows,
                                                dc, stream)
                 : launch<MASKED, false, LOCAL>(q, est, cb, mask, alpha,
                                                 new_est, N, F, M, D, rows,
                                                 dc, stream);
}

}  // namespace

extern "C" {

// Launches one fused sweep on `stream`; `mask` null selects the dense
// variant, `local` (with a mask) the model-shard variant, whose `new_est`
// receives the fp32 partial projection.  Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue for `local` without a
// mask.
int resonator_step_launch(const float* q, const float* est, const float* cb,
                          const float* mask, float* alpha, float* new_est,
                          int N, int F, int M, int D, int rows, int dc,
                          int use_abs, int local, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (local) {
    if (mask == nullptr) return (int)cudaErrorInvalidValue;
    return launch_act<true, true>(q, est, cb, mask, alpha, new_est, N, F, M,
                                  D, rows, dc, use_abs, s);
  }
  if (mask != nullptr)
    return launch_act<true, false>(q, est, cb, mask, alpha, new_est, N, F, M,
                                   D, rows, dc, use_abs, s);
  return launch_act<false, false>(q, est, cb, mask, alpha, new_est, N, F, M,
                                  D, rows, dc, use_abs, s);
}

const char* resonator_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
