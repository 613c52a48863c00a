// Row-wise circular convolution, written for Hopper (sm_90a), fp32 FMAs on
// the CUDA cores.
//
// Replaces the two TPU kernels of src/repro/kernels/circconv/kernel.py:
//   circconv_rows        (many independent rows; every block-code bind and
//                         unbind of vsa.bind(impl="pallas"))
//   circconv_single_mxu  (one long row, L >= 512: the HRR corner, B = 1)
// Both compute
//
//   o[r, n] = sum_k x[r, k] * y[r, (n - k) mod L]        (fp32 sums)
//
// with x, y [N, L] fp32 or bf16 and o [N, L] in x's type.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): at MIMONet's serving
// shape (N = 4096 rows, L = 256, fp32) one launch reads x and y (8.4 MB) and
// writes o (4.2 MB): 3.8 us at the memory rate.  The cheapest method, three
// FFTs and a product, needs 0.066 GFLOP (1.0 us), so the function is bound
// by its bytes.  This direct kernel does 2 N L^2 = 0.54 GFLOP (8.0 us at the
// fp32 rate) and so cannot reach that bound; the single-row kernel at
// L = 2048 (24.6 KB, 8.4 MFLOP direct) is bound by its launch in practice.
//
// What the design does about its FMAs: like the TPU kernel, it keeps both
// O(L) operands on chip and never forms the L x L circulant.  A block stages
// x (zero-padded to Lp, a multiple of 8) and a window of the doubled y in
// shared memory, converted to fp32.  Each thread owns 8 consecutive outputs
// n0..n0+7 and walks k in chunks of 8; the 64 products of a chunk need only
// the 15 values y[n0 - k0 - 7 .. n0 - k0 + 7], and 7 of them carry over to the
// next chunk, so a chunk costs 64 FMAs, 8 loads of y and 2 16-byte
// (broadcast) loads of x.  The window is stored de-interleaved by 8 (element
// w at [w % 8][w / 8]), so the 8 threads of neighbouring output groups read
// neighbouring words: no bank conflicts.
//
// circconv_rows: one thread group per row, Lp / 8 threads (at most 256; a
// thread walks several output groups beyond that), R rows per block so that a
// block has about 256 threads; each output sums k in order 0..L-1.
// circconv_single: the grid splits the outputs into tiles of TN = 64, and a
// block splits k into KS = 32 slices of 8 threads each; the slices' partial
// sums are added in slice order through shared memory (no atomics: the same
// bits from run to run).
//
// Shared memory per row: 4 (Lp + Lp + TN + 8) bytes (rows: TN = Lp), up to
// 227 KB with the opt-in attribute: L <= 16384.  kernel.py's rows_geometry
// and single_geometry compute the bytes and pass them in; kernel.py::MAX_L
// checks the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;        // outputs per thread, and k per step
constexpr int kRowsThreads = 256;  // most threads per rows block
constexpr int kTile = 64;        // single: outputs per block
constexpr int kSlices = 32;      // single: k slices per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stages x (zero-padded to Lp) and the y window of one output tile.  The
// window holds yd[w] = y[(eb + w) mod L] for w in [0, W), eb = n0 + L - Lp - 7,
// W = TN + Lp + 8, de-interleaved by 8 into ys[(w % 8) * (W / 8) + w / 8].
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ y, float* xs,
                                      float* ys, int L, int Lp, int n0, int TN,
                                      int tid, int nthreads) {
  for (int k = tid; k < Lp; k += nthreads)
    xs[k] = k < L ? to_f32(x[k]) : 0.f;
  const int W = TN + Lp + kChunk, P = W / kChunk;
  const int eb = n0 + L - Lp - 7;
  for (int w = tid; w < W; w += nthreads) {
    int e = (eb + w) % L;
    if (e < 0) e += L;
    ys[(w & 7) * P + (w >> 3)] = to_f32(y[e]);
  }
}

// acc[j] += sum over k in [kbeg, kend) of xs[k] * y[(n0 + 8 g + j - k) mod L],
// k in order, for the output group g of a tile whose window starts at
// n0 + L - Lp - 7 (see stage).  kbeg and kend are multiples of 8.
__device__ __forceinline__ void accumulate(const float* xs, const float* ys,
                                           int P, int Lp, int g, int kbeg,
                                           int kend, float acc[kChunk]) {
  if (kbeg >= kend) return;
  // The window value for offset c = j - i in [-7, 7] at chunk k0 is
  // yd[8 g + Lp + 7 - k0 + c]; with B = (Lp - k0) / 8 that is, for c <= 0,
  // ys[(7 + c) P + g + B] (lo[7 + c]) and, for c >= 1, ys[(c - 1) P + g + B
  // + 1] (hi[c - 1]).  Moving to k0 + 8, hi takes over lo[0..6].
  float lo[kChunk], hi[kChunk - 1];
  int q = g + (Lp - kbeg) / kChunk;
#pragma unroll
  for (int p = 0; p < kChunk - 1; ++p) hi[p] = ys[p * P + q + 1];
  for (int k0 = kbeg; k0 < kend; k0 += kChunk, --q) {
#pragma unroll
    for (int p = 0; p < kChunk; ++p) lo[p] = ys[p * P + q];
    const float4 xa = *reinterpret_cast<const float4*>(xs + k0);
    const float4 xb = *reinterpret_cast<const float4*>(xs + k0 + 4);
    const float xv[kChunk] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int c = j - i;
        const float yv = c <= 0 ? lo[7 + c] : hi[c - 1];
        acc[j] = fmaf(xv[i], yv, acc[j]);
      }
    }
#pragma unroll
    for (int p = 0; p < kChunk - 1; ++p) hi[p] = lo[p];
  }
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ o, int n, int L,
                                      const float acc[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (n + j < L) o[n + j] = from_f32<T>(acc[j]);
}

// Grid (ceil(N / R)); block R * tpr threads, thread group r owns row
// blockIdx.x * R + r.  Shared memory: R rows of [Lp] x then [2 Lp + 8] window.
template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
circconv_rows_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     T* __restrict__ o, int N, int L, int Lp, int R, int tpr) {
  extern __shared__ __align__(16) float smem[];
  const int r = threadIdx.x / tpr, t = threadIdx.x - r * tpr;
  const int row = blockIdx.x * R + r;
  const int per_row = Lp + 2 * Lp + kChunk;
  float* xs = smem + r * per_row;
  float* ys = xs + Lp;
  if (row < N) {
    const size_t off = (size_t)row * L;
    stage(x + off, y + off, xs, ys, L, Lp, 0, Lp, t, tpr);
  }
  __syncthreads();
  if (row >= N) return;
  const int P = (2 * Lp + kChunk) / kChunk;
  for (int g = t; g < Lp / kChunk; g += tpr) {
    float acc[kChunk] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    accumulate(xs, ys, P, Lp, g, 0, Lp, acc);
    store(o + (size_t)row * L, g * kChunk, L, acc);
  }
}

// Grid (ceil(Lp / kTile)); block kSlices * (kTile / 8) threads.  Slice s sums its
// share of k for the tile's 64 outputs; the slices' partials meet in red.
template <typename T>
__global__ void __launch_bounds__(kSlices * kTile / kChunk)
circconv_single_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       T* __restrict__ o, int L, int Lp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int tpt = kTile / kChunk;  // threads per slice
  float* xs = smem;
  float* ys = xs + Lp;
  const int W = kTile + Lp + kChunk;
  float* red = ys + W;  // [kSlices][kTile]
  const int n0 = blockIdx.x * kTile;
  const int s = threadIdx.x / tpt, g = threadIdx.x - s * tpt;
  stage(x, y, xs, ys, L, Lp, n0, kTile, threadIdx.x, blockDim.x);
  __syncthreads();
  const int chunks = Lp / kChunk;
  const int per = (chunks + kSlices - 1) / kSlices;
  const int kbeg = min(s * per, chunks) * kChunk;
  const int kend = min((s + 1) * per, chunks) * kChunk;
  float acc[kChunk] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  accumulate(xs, ys, W / kChunk, Lp, g, kbeg, kend, acc);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) red[s * kTile + g * kChunk + j] = acc[j];
  __syncthreads();
  for (int n = threadIdx.x; n < kTile; n += blockDim.x) {
    float v = 0.f;
    for (int i = 0; i < kSlices; ++i) v += red[i * kTile + n];
    if (n0 + n < L) o[n0 + n] = from_f32<T>(v);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
int rows(const void* x, const void* y, void* o, int N, int L, int Lp, int R,
         int tpr, int smem, cudaStream_t stream) {
  int rc = set_smem(circconv_rows_kernel<T>, smem);
  if (rc) return rc;
  circconv_rows_kernel<T><<<(N + R - 1) / R, R * tpr, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o),
      N, L, Lp, R, tpr);
  return (int)cudaGetLastError();
}

template <typename T>
int single(const void* x, const void* y, void* o, int L, int Lp, int smem,
           cudaStream_t stream) {
  int rc = set_smem(circconv_single_kernel<T>, smem);
  if (rc) return rc;
  circconv_single_kernel<T><<<Lp / kTile + (Lp % kTile != 0),
                              kSlices * kTile / kChunk, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o),
      L, Lp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one circconv_rows on `stream`: x, y, o [N, L] contiguous, dtype 0
// (fp32) or 1 (bf16); Lp = L rounded up to 8; R rows of tpr = min(Lp / 8,
// 256) threads per block and smem bytes of shared memory, all from
// kernel.py::rows_geometry.  Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a dtype the kernel lacks.
int circconv_rows_launch(const void* x, const void* y, void* o, int N, int L,
                         int Lp, int R, int tpr, int smem, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rows<float>(x, y, o, N, L, Lp, R, tpr, smem, s);
  if (dtype == 1)
    return rows<__nv_bfloat16>(x, y, o, N, L, Lp, R, tpr, smem, s);
  return (int)cudaErrorInvalidValue;
}

// Launches one circconv_single on `stream`: x, y, o [L] contiguous, dtype as
// above, Lp = L rounded up to 8, smem from kernel.py::single_geometry.
int circconv_single_launch(const void* x, const void* y, void* o, int L,
                           int Lp, int smem, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return single<float>(x, y, o, L, Lp, smem, s);
  if (dtype == 1) return single<__nv_bfloat16>(x, y, o, L, Lp, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* circconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
