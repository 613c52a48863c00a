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
// fp32 scales [NBP, bs, G, 1] per (token, head) multiplied in at load;
// table [B, W] int32; kv_lens [B] int32; out [B, G, rep, DH] fp32.  A row
// with kv_lens = 0 gives exact zeros, as the Pallas kernel does.
//
// Bound on the H100 (SXM, 3.35 TB/s): by bytes, the K/V read.  A decode
// step of Llama 3.2 3B at 32 slots and a mean live length near 288 reads
// 32 x 288 positions x 8 heads x 128 x 2 (K, V) x 2 bytes, about 38 MB per
// launch (11 us), against 4 x 32 x 24 x 288 x 128 = 113 MFLOP.  What the
// design does about the bytes: only the live blocks are read (blocks past
// ceil(len / bs) are neither loaded nor computed; the Pallas version still
// copies them); each K/V row is read once, with 16-byte loads, neighbouring
// threads on neighbouring addresses, and shared by the rep query heads of
// its KV head; the int8 pool is dequantised in registers, never widened in
// device memory.
//
// Design: one block of 128 threads per (KV head g, row b).  The block walks
// the row's live positions in tiles of kTile = 32 (whole blocks of the
// table when bs divides 32; any bs works), reading each position's physical
// block id from table[b, t / bs] itself.  Per tile: K and V are staged in
// shared memory as fp32 (positions past kv_lens as zeros); each warp scores
// a quarter of the tile's positions against the rep query heads (lanes over
// DH, shuffle-reduced in a fixed order); one warp per query head updates
// the running max m, sum l and the scale of the accumulator with expf (not
// __expf: the contract with the plain version is 2e-5), masking positions
// >= kv_lens (and block ids outside the pool) to -1e30 as the reference
// does; every thread then owns fixed (head, d) entries of the fp32
// accumulator [rep, DH] in registers.  At the end acc / max(l, 1e-30) is
// written.  No atomics: the same bits every run.
//
// Not done yet (later work): split-KV (flash-decoding) across blocks for
// long contexts and small batches, where (B x G) blocks leave SMs idle;
// cp.async or TMA double buffering of the tiles; wgmma for the products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // KV positions per tile: one per lane
constexpr int kMaxRep = 8;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16 bytes of a K/V row as fp32: 8 bf16 values, or 16 int8 values times
// the row's scale.
template <bool QUANT>
__device__ __forceinline__ void unpack(const uint4 w, float scale,
                                       float* dst) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (QUANT) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[4 * i + j] =
            (float)(int8_t)((words[i] >> (8 * j)) & 0xffu) * scale;
    } else {
      dst[2 * i] = __uint_as_float(words[i] << 16);
      dst[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

template <int DH, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,        // [B, G, rep, DH]
                    const uint4* __restrict__ k_pool,   // [NBP, bs, G, DH]
                    const uint4* __restrict__ v_pool,   // [NBP, bs, G, DH]
                    const float* __restrict__ k_scale,  // [NBP, bs, G]
                    const float* __restrict__ v_scale,  // [NBP, bs, G]
                    const int* __restrict__ table,      // [B, W]
                    const int* __restrict__ kv_lens,    // [B]
                    float* __restrict__ out,            // [B, G, rep, DH]
                    int G, int rep, int nbp, int bs, int W) {
  constexpr int kPer = QUANT ? 16 : 8;      // values per 16-byte load
  constexpr int kChunks = DH / kPer;        // 16-byte loads per K/V row
  constexpr int kLoads = (kTile * kChunks + kThreads - 1) / kThreads;
  constexpr int kAcc = (kMaxRep * DH + kThreads - 1) / kThreads;

  __shared__ __align__(16) float qs[kMaxRep * DH];
  __shared__ __align__(16) float ks[kTile * DH];
  __shared__ __align__(16) float vs[kTile * DH];
  __shared__ float ps[kMaxRep * kTile];  // scores, then probabilities
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], c_s[kMaxRep];
  __shared__ int rows_s[kTile];  // (token, head) row of each position, or -1

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(kv_lens[b], W * bs));
  const float* qb = q + ((size_t)b * G + g) * rep * DH;
  for (int i = tid; i < rep * DH; i += kThreads) qs[i] = qb[i];
  if (tid < rep) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    if (tid < kTile) {
      int row = -1;
      if (tid < n) {
        const int pos = t0 + tid, blk = pos / bs;
        const int phys = table[(size_t)b * W + blk];
        if (phys >= 0 && phys < nbp)
          row = (phys * bs + (pos - blk * bs)) * G + g;
      }
      rows_s[tid] = row;
    }
    __syncthreads();
    // Stage the tile's K and V rows as fp32, 16 bytes a load.
    uint4 kw[kLoads], vw[kLoads];
    float ksc[kLoads], vsc[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kChunks, c = i - t * kChunks;
      const int row = i < kTile * kChunks ? rows_s[t] : -1;
      kw[j] = vw[j] = make_uint4(0u, 0u, 0u, 0u);
      ksc[j] = vsc[j] = 0.f;
      if (row >= 0) {
        kw[j] = k_pool[(size_t)row * kChunks + c];
        vw[j] = v_pool[(size_t)row * kChunks + c];
        if (QUANT) {
          ksc[j] = k_scale[row];
          vsc[j] = v_scale[row];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kTile * kChunks) {
        const int t = i / kChunks, c = i - t * kChunks;
        unpack<QUANT>(kw[j], ksc[j], ks + t * DH + c * kPer);
        unpack<QUANT>(vw[j], vsc[j], vs + t * DH + c * kPer);
      }
    }
    __syncthreads();
    // Scores of the rep query heads against the tile's positions.
    for (int t = warp; t < kTile; t += kWarps) {
      for (int r = 0; r < rep; ++r) {
        float a = 0.f;
#pragma unroll
        for (int d = lane; d < DH; d += 32)
          a = fmaf(qs[r * DH + d], ks[t * DH + d], a);
        a = warp_sum(a);
        if (lane == 0) ps[r * kTile + t] = rows_s[t] >= 0 ? a : kNeg;
      }
    }
    __syncthreads();
    // Online softmax: one warp per query head, one position per lane.
    for (int r = warp; r < rep; r += kWarps) {
      const float s = ps[r * kTile + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      ps[r * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc[r, d] = acc[r, d] * corr[r] + sum_t p[r, t] V[t, d]
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < rep * DH) {
        const int r = idx / DH, d = idx - r * DH;
        float a = acc[k] * c_s[r];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t)
          a = fmaf(ps[r * kTile + t], vs[t * DH + d], a);
        acc[k] = a;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps
  }

  float* ob = out + ((size_t)b * G + g) * rep * DH;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < rep * DH) ob[idx] = acc[k] / fmaxf(l_s[idx / DH], 1e-30f);
  }
}

template <int DH>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* lens, float* out,
           int B, int G, int rep, int nbp, int bs, int W, bool quant,
           cudaStream_t stream) {
  const dim3 grid(G, B);
  const uint4* k4 = static_cast<const uint4*>(k);
  const uint4* v4 = static_cast<const uint4*>(v);
  if (quant)
    flash_decode_kernel<DH, true><<<grid, kThreads, 0, stream>>>(
        q, k4, v4, ks, vs, table, lens, out, G, rep, nbp, bs, W);
  else
    flash_decode_kernel<DH, false><<<grid, kThreads, 0, stream>>>(
        q, k4, v4, ks, vs, table, lens, out, G, rep, nbp, bs, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one flash_decode on `stream`.  dh is 16, 32, 64 or 128; rep at
// most 8; the pools 16-byte aligned; k_scale / v_scale are read only
// when quant != 0.  nbp is the number of physical blocks: a table id outside
// [0, nbp) is masked like a position past kv_lens, never read.  Returns
// cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a shape
// the kernel lacks.
int flash_decode_launch(const float* q, const void* k_pool,
                        const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* table,
                        const int* kv_lens, float* out, int B, int G, int rep,
                        int nbp, int bs, int W, int dh, int quant,
                        void* stream) {
  if (rep < 1 || rep > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool qt = quant != 0;
  switch (dh) {
    case 16:
      return launch<16>(q, k_pool, v_pool, k_scale, v_scale, table, kv_lens,
                        out, B, G, rep, nbp, bs, W, qt, s);
    case 32:
      return launch<32>(q, k_pool, v_pool, k_scale, v_scale, table, kv_lens,
                        out, B, G, rep, nbp, bs, W, qt, s);
    case 64:
      return launch<64>(q, k_pool, v_pool, k_scale, v_scale, table, kv_lens,
                        out, B, G, rep, nbp, bs, W, qt, s);
    case 128:
      return launch<128>(q, k_pool, v_pool, k_scale, v_scale, table, kv_lens,
                         out, B, G, rep, nbp, bs, W, qt, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
