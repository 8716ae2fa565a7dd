// Masked mean over stacked per-worker gradients for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `masked_grad_agg` in
// src/repro/kernels/masked_grad_agg.py (entry :32, pallas_call :42, body
// `_kernel` :23).  It computes `reference_masked_agg` of
// src/repro_torch/kernels/ref.py: grads (W, N) and a float mask (W,) give
//     out[j] = (sum_w m_w * g[w, j]) / max(sum_w m_w, 1)
// with products and sums in f32 and the output in the grads' dtype.  This is
// the cutoff combine of paper Alg. 1 line 29 (a 0/1 bit array) and the
// anytime combine (fractional contributions).  In sum mode (`mean` 0) the
// kernel writes the masked sum `sum_w m_w * g[w, j]` undivided: a rank's
// share of the data-parallel combine, which an all-reduce over the ranks
// completes before the division by the global c
// (repro_torch/core/aggregation.py `masked_psum_mean`).  Both modes read
// and write the same bytes.
//
// What bounds it on the H100.  Bytes: each of the W*N inputs is read once
// and each of the N outputs written once, against 2*W*N flops.  At the
// training slice's shape (W = 8, N = 494,032,768 f32, full-width
// qwen2-0.5b) that is 15.81 GB read + 1.98 GB written, 5.31 ms at
// 3.35 TB/s.  The design streams every byte exactly once:
//   * a 1-D grid over columns; each thread owns 4 consecutive columns and
//     loops over the W rows, so every load is a 16-byte (f32) or 8-byte
//     (bf16) vector and a warp reads 512 (256) contiguous bytes of one row;
//     the W loads of a thread are independent, which keeps many requests in
//     flight per thread;
//   * the mask goes to shared memory once per block (W <= a few hundred:
//     the paper's cluster has 158 workers), and each block computes
//     c = max(sum m, 1) from that copy, so no second pass and no host value;
//   * the row pitch is an argument and the ragged tail of N is masked in
//     the kernel, so any N works and nothing is padded or copied.
// Products and sums use __fmul_rn/__fadd_rn (no FMA contraction), so each
// term rounds as the plain version's separate multiply and add do; only the
// order of the W-term sum may differ from it.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).  The
// launch goes on the caller's stream; the function returns the CUDA error of
// the launch (0 on success) or a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;   // columns per thread
// The mask and c share one dynamic buffer of W + 1 floats, which must fit
// the default 48 KB of shared memory per block.
constexpr int MAX_WORKERS = 12287;
static_assert((MAX_WORKERS + 1) * sizeof(float) <= 48 * 1024,
              "the mask buffer must fit 48 KB of shared memory");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements as one vector load / store.
__device__ __forceinline__ void load4(const float* p, float (&x)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&x)[VEC]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// VECTOR: every row start and the output are aligned for 4-wide access
// (the wrapper checks the pointers and the pitch).  MEAN: divide by c; else
// write the masked sum.
template <typename T, bool VECTOR, bool MEAN>
__global__ void __launch_bounds__(THREADS)
masked_agg(const T* __restrict__ g, const float* __restrict__ mask,
           T* __restrict__ out, int W, long long N, long long pitch) {
  extern __shared__ float msk[];   // W mask values, then c
  for (int w = threadIdx.x; w < W; w += THREADS) msk[w] = mask[w];
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s = __fadd_rn(s, msk[w]);
    msk[W] = fmaxf(s, 1.f);
  }
  __syncthreads();
  const float c = msk[W];

  const long long col = (static_cast<long long>(blockIdx.x) * THREADS +
                         threadIdx.x) * VEC;
  if (col >= N) return;
  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
  if (VECTOR && col + VEC <= N) {
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      float x[VEC];
      load4(g + w * pitch + col, x);
      const float m = msk[w];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], m));
    }
    float y[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[j] = MEAN ? __fdiv_rn(acc[j], c) : acc[j];
    store4(out + col, y);
    return;
  }
  const int n = static_cast<int>(min(static_cast<long long>(VEC), N - col));
  for (int w = 0; w < W; ++w) {
    const T* row = g + w * pitch + col;
    const float m = msk[w];
    for (int j = 0; j < n; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(row[j]), m));
  }
  for (int j = 0; j < n; ++j)
    store(out + col + j, MEAN ? __fdiv_rn(acc[j], c) : acc[j]);
}

template <typename T, bool MEAN>
int launch(const void* g, const float* mask, void* out, int W, long long N,
           long long pitch, int vector, cudaStream_t stream) {
  const long long threads = (N + VEC - 1) / VEC;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -3;
  const size_t smem = static_cast<size_t>(W + 1) * sizeof(float);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (vector) {
    masked_agg<T, true, MEAN><<<static_cast<unsigned>(blocks), THREADS,
                                smem, stream>>>(gt, mask, ot, W, N, pitch);
  } else {
    masked_agg<T, false, MEAN><<<static_cast<unsigned>(blocks), THREADS,
                                 smem, stream>>>(gt, mask, ot, W, N, pitch);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(const void* g, const float* mask, void* out, int W,
                long long N, long long pitch, int vector, int mean,
                cudaStream_t stream) {
  if (mean) return launch<T, true>(g, mask, out, W, N, pitch, vector, stream);
  return launch<T, false>(g, mask, out, W, N, pitch, vector, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (grads and output alike).  pitch is the
// distance between rows of g in elements; mask holds W float32 values.
// mean: 1 divides by max(sum m, 1), 0 writes the masked sum.
extern "C" int masked_grad_agg(const void* g, const void* mask, void* out,
                               int dtype, int W, long long N,
                               long long pitch, int vector, int mean,
                               void* stream) {
  if (W < 1 || W > MAX_WORKERS || N < 1 || pitch < N) return -1;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mode<float>(g, m, out, W, N, pitch, vector, mean, st);
  if (dtype == 1)
    return launch_mode<__nv_bfloat16>(g, m, out, W, N, pitch, vector, mean,
                                      st);
  return -2;
}

extern "C" int masked_grad_agg_max_workers() { return MAX_WORKERS; }
