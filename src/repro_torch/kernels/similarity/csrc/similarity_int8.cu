// Codebook similarity against an int8 codebook, dequantized in registers,
// written for Hopper (sm_90a), fp32 on the CUDA cores.
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
// bytes, and in practice by the launch itself.  What the design does about
// the bytes: each block stages a [TM, DC] tile of w in shared memory once and
// serves it to all of its query rows, so w crosses device memory once per
// row tile and q once per M tile (once in all at M <= TM); q is read with
// 16-byte loads along D, neighbouring lanes on neighbouring addresses; the
// int8 codebook is never widened in device memory.
//
// Geometry (chosen by the Python wrapper, kernel.py::launch_geometry): grid
// (ceil(N / kWarps), ceil(M / TM)), kWarps warps per block, one query row per
// warp.  TM in {8, 16, 32} codebook rows per block; each lane keeps TM
// partial sums in registers over its share of D, D is walked in chunks of DC
// lanes (DC a multiple of 16, TM * DC bytes of shared memory), and each
// partial sum is reduced by shuffles in a fixed order: no atomics, so the
// result is the same bits from run to run.  VEC selects 16-byte q loads and
// 4-byte w loads (D % 4 == 0 and aligned pointers); otherwise one element at
// a time, which serves any D.  Rows of the w tile past M are staged as zeros
// and never written out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int TM, bool VEC>
__global__ void __launch_bounds__(kThreads)
similarity_int8_kernel(const float* __restrict__ q,        // [N, D]
                       const int8_t* __restrict__ w,       // [M, D]
                       const float* __restrict__ scale,    // [M]
                       float* __restrict__ out,            // [N, M]
                       int N, int M, int D, int dc) {
  extern __shared__ __align__(16) int8_t ws[];  // [TM][dc]  w tile chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * TM;
  const bool live = n < N;  // warp-uniform; idle warps still stage and sync

  float acc[TM];
#pragma unroll
  for (int k = 0; k < TM; ++k) acc[k] = 0.f;

  for (int d0 = 0; d0 < D; d0 += dc) {
    const int len = min(dc, D - d0);
    __syncthreads();  // the previous chunk's readers are done
    if (VEC) {
      const int len4 = len >> 2, dc4 = dc >> 2;
      const int* w4 = reinterpret_cast<const int*>(w);
      int* ws4 = reinterpret_cast<int*>(ws);
      for (int i = tid; i < TM * len4; i += kThreads) {
        const int m = i / len4, j = i - m * len4;
        ws4[m * dc4 + j] =
            m0 + m < M ? w4[((size_t)(m0 + m) * D + d0) / 4 + j] : 0;
      }
    } else {
      for (int i = tid; i < TM * len; i += kThreads) {
        const int m = i / len, j = i - m * len;
        ws[m * dc + j] = m0 + m < M ? w[(size_t)(m0 + m) * D + d0 + j] : 0;
      }
    }
    __syncthreads();
    if (!live) continue;
    if (VEC) {
      const float4* q4 =
          reinterpret_cast<const float4*>(q + (size_t)n * D + d0);
      const int* ws4 = reinterpret_cast<const int*>(ws);
      const int dc4 = dc >> 2;
      for (int j = lane; j < (len >> 2); j += 32) {
        const float4 qv = q4[j];
#pragma unroll
        for (int k = 0; k < TM; ++k) {
          const int packed = ws4[k * dc4 + j];
          const float w0 = (float)(int8_t)(packed & 0xff);
          const float w1 = (float)(int8_t)((packed >> 8) & 0xff);
          const float w2 = (float)(int8_t)((packed >> 16) & 0xff);
          const float w3 = (float)(int8_t)((packed >> 24) & 0xff);
          float a = acc[k];
          a = fmaf(qv.x, w0, a);
          a = fmaf(qv.y, w1, a);
          a = fmaf(qv.z, w2, a);
          a = fmaf(qv.w, w3, a);
          acc[k] = a;
        }
      }
    } else {
      const float* qn = q + (size_t)n * D + d0;
      for (int j = lane; j < len; j += 32) {
        const float qv = qn[j];
#pragma unroll
        for (int k = 0; k < TM; ++k)
          acc[k] = fmaf(qv, (float)ws[k * dc + j], acc[k]);
      }
    }
  }
  if (!live) return;  // after the last __syncthreads: safe to leave

#pragma unroll
  for (int k = 0; k < TM; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && m0 + k < M)
      out[(size_t)n * M + m0 + k] = v * scale[m0 + k];
  }
}

template <int TM>
int launch(const float* q, const int8_t* w, const float* scale, float* out,
           int N, int M, int D, int dc, bool vec, cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, (M + TM - 1) / TM);
  const size_t smem = (size_t)TM * dc;
  if (vec)
    similarity_int8_kernel<TM, true>
        <<<grid, kThreads, smem, stream>>>(q, w, scale, out, N, M, D, dc);
  else
    similarity_int8_kernel<TM, false>
        <<<grid, kThreads, smem, stream>>>(q, w, scale, out, N, M, D, dc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one similarity_int8 on `stream`.  tm is 8, 16 or 32; dc a
// multiple of 16 with tm * dc <= 48 KB; vec requires D % 4 == 0, q 16-byte
// aligned and w 4-byte aligned.  Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a tm the kernel lacks.
int similarity_int8_launch(const float* q, const int8_t* w,
                           const float* scale, float* out, int N, int M,
                           int D, int tm, int dc, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 8: return launch<8>(q, w, scale, out, N, M, D, dc, vec != 0, s);
    case 16: return launch<16>(q, w, scale, out, N, M, D, dc, vec != 0, s);
    case 32: return launch<32>(q, w, scale, out, N, M, D, dc, vec != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* similarity_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
