// Codebook similarity against an int8 codebook, written for Hopper (sm_90a),
// fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/similarity/kernel.py:
// similarity_int8 (factorizer Step 2 with int8 codebooks, paper Sec. IV-B):
//
//   scores[n, m] = scale[m] * sum_d q[n, d] * w[m, d]        (fp32 sums)
//
// q [N, D] fp32, w [M, D] int8, scale [M] fp32 (the [M, 1] column), scores
// [N, M] fp32.  The TPU kernel multiplies each w element by its row scale
// before the product; here the scale multiplies the finished sum once, which
// is the same function up to fp32 rounding (about 1e-6 relative).
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): at the serving shape
// (N = 256 rows, M = 10, D = 1024) one launch must read q (1.05 MB), w
// (10 KB) and the scales and write the scores (10 KB): 1.07 MB, 0.32 us at
// the memory rate, against 5.2 MFLOP, 0.08 us at the fp32 rate.  Bound by
// bytes, and in practice by the launch, one memory latency and the block's
// reduction.  Tensor cores are not the lever: the operations are too few to
// matter, and TF32 or bf16 inputs would change the fp32 products.
//
// Design: a block owns a tile of TN query rows and TM codebook rows and
// splits D over its 128 threads, each thread taking every 128th group of 4
// elements.  A thread loads its TN q vectors (16-byte loads) and TM packed
// int8 words (4-byte loads) of a group together, ahead of any arithmetic,
// widens each int8 word once (an exact byte permute into the mantissa of
// 2^23 and a subtract; no I2F) and uses it for all TN rows, so every
// codebook element is dequantized once per block and every q element is read
// once per M tile.  The TN x TM partial sums are then reduced in a fixed
// order: a reduce-scatter across each warp's lanes (31 shuffles for up to 32
// sums; lane l ends holding sum l) and a sum over the 4 warps in warp order
// through shared memory.  No atomics: a launch's bits repeat.
//
// Geometry (kernel.py::launch_geometry): M is cut into ceil(M / 16) tiles of
// TM = ceil(M / tiles) rows, so M <= 16 (M = 10 on the serving path) is
// covered exactly; TN in {4, 2, 1} is the largest with TN * TM <= 32 whose
// grid (ceil(N / TN), tiles) still has a block for every SM.  Rows past N or
// M in a ragged tile read the last row again and are never written.  VEC
// selects the 16-byte path (D % 4 == 0, q 16-byte and w 4-byte aligned);
// otherwise one element at a time, which serves any D and alignment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 32;  // TN * TM: one warp's lanes hold the sums

// Four int8 values of a little-endian word, exactly, as fp32: each byte
// plus 128 is placed in the mantissa of 2^23, and 2^23 + 128 subtracted.
__device__ __forceinline__ float4 widen(int packed) {
  const unsigned u = static_cast<unsigned>(packed) ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias);
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

template <int TN, int TM>
__global__ void __launch_bounds__(kThreads)
similarity_int8_kernel(const float* __restrict__ q,        // [N, D]
                       const int8_t* __restrict__ w,       // [M, D]
                       const float* __restrict__ scale,    // [M]
                       float* __restrict__ out,            // [N, M]
                       int N, int M, int D, int vec) {
  constexpr int V = TN * TM, P = pow2_at_least(V);
  static_assert(V <= kMaxTile, "a tile's sums must fit one warp's lanes");
  __shared__ float red[kWarps][P];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  size_t qrow[TN], wrow[TM];  // element offsets of the tile's rows
#pragma unroll
  for (int r = 0; r < TN; ++r) qrow[r] = (size_t)min(n0 + r, N - 1) * D;
#pragma unroll
  for (int k = 0; k < TM; ++k) wrow[k] = (size_t)min(m0 + k, M - 1) * D;

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;

  if (vec) {
    const int d4 = D >> 2;
    for (int j = tid; j < d4; j += kThreads) {
      float4 qv[TN];
      int wv[TM];
#pragma unroll
      for (int r = 0; r < TN; ++r)
        qv[r] = __ldg(reinterpret_cast<const float4*>(q + qrow[r]) + j);
#pragma unroll
      for (int k = 0; k < TM; ++k)
        wv[k] = __ldg(reinterpret_cast<const int*>(w + wrow[k]) + j);
#pragma unroll
      for (int k = 0; k < TM; ++k) {
        const float4 x = widen(wv[k]);
#pragma unroll
        for (int r = 0; r < TN; ++r) {
          float a = acc[r * TM + k];
          a = fmaf(qv[r].x, x.x, a);
          a = fmaf(qv[r].y, x.y, a);
          a = fmaf(qv[r].z, x.z, a);
          a = fmaf(qv[r].w, x.w, a);
          acc[r * TM + k] = a;
        }
      }
    }
  } else {
    for (int j = tid; j < D; j += kThreads) {
      float qv[TN], x[TM];
#pragma unroll
      for (int r = 0; r < TN; ++r) qv[r] = __ldg(q + qrow[r] + j);
#pragma unroll
      for (int k = 0; k < TM; ++k) x[k] = (float)__ldg(w + wrow[k] + j);
#pragma unroll
      for (int k = 0; k < TM; ++k)
#pragma unroll
        for (int r = 0; r < TN; ++r)
          acc[r * TM + k] = fmaf(qv[r], x[k], acc[r * TM + k]);
    }
  }

  reduce_scatter<P, P, 16>(acc, lane);
  if (lane < P) red[warp][lane] = acc[0];
  __syncthreads();
  if (tid < V) {
    float s = red[0][tid];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi][tid];
    const int n = n0 + tid / TM, m = m0 + tid % TM;
    if (n < N && m < M) out[(size_t)n * M + m] = s * scale[m];
  }
}

typedef int (*launch_fn)(const float*, const int8_t*, const float*, float*,
                         int, int, int, int, cudaStream_t);

template <int TN, int TM>
int launch(const float* q, const int8_t* w, const float* scale, float* out,
           int N, int M, int D, int vec, cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  similarity_int8_kernel<TN, TM>
      <<<grid, kThreads, 0, stream>>>(q, w, scale, out, N, M, D, vec);
  return (int)cudaGetLastError();
}

template <int TN, int TM>
constexpr launch_fn pick() {
  if constexpr (TN * TM <= kMaxTile) return launch<TN, TM>;
  else return nullptr;
}

#define SIM_ROW(TM) {pick<1, TM>(), pick<2, TM>(), pick<4, TM>()}
// kLaunch[TM - 1][log2 TN]
const launch_fn kLaunch[16][3] = {
    SIM_ROW(1),  SIM_ROW(2),  SIM_ROW(3),  SIM_ROW(4),
    SIM_ROW(5),  SIM_ROW(6),  SIM_ROW(7),  SIM_ROW(8),
    SIM_ROW(9),  SIM_ROW(10), SIM_ROW(11), SIM_ROW(12),
    SIM_ROW(13), SIM_ROW(14), SIM_ROW(15), SIM_ROW(16)};
#undef SIM_ROW

}  // namespace

extern "C" {

// Launches one similarity_int8 on `stream`.  tm in 1..16 codebook rows and
// tn in {1, 2, 4} query rows a block, tn * tm <= 32; vec requires D % 4 ==
// 0, q 16-byte aligned and w 4-byte aligned.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a tile the
// kernel lacks.
int similarity_int8_launch(const float* q, const int8_t* w,
                           const float* scale, float* out, int N, int M,
                           int D, int tn, int tm, int vec, void* stream) {
  const int col = tn == 1 ? 0 : tn == 2 ? 1 : tn == 4 ? 2 : -1;
  if (tm < 1 || tm > 16 || col < 0 || kLaunch[tm - 1][col] == nullptr)
    return (int)cudaErrorInvalidValue;
  return kLaunch[tm - 1][col](q, w, scale, out, N, M, D, vec,
                              static_cast<cudaStream_t>(stream));
}

const char* similarity_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
