// Fused AdamW update over every leaf of a parameter tree, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_adam` in
// src/repro/kernels/fused_adam.py (entry :40, pallas_call :55, body
// `_kernel` :21).  For each element, in f32:
//     m' = b1 m + (1 - b1) g
//     v' = b2 v + (1 - b2) g g
//     p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)
// with bc1 = 1 - b1^t, bc2 = 1 - b2^t, t = step + 1: `reference_adam` of
// src/repro_torch/kernels/ref.py.  p and g are f32 or bf16, m and v f32;
// p' keeps p's dtype.  p, m and v are written IN PLACE.
//
// What bounds it on the H100.  Bytes: p, g, m, v are read once and p, m, v
// written once, about 12 flops an element.  With bf16 p and g that is
// 2+2+4+4 read + 2+4+4 written = 22 bytes per parameter: 10.87 GB for the
// 494,032,768 parameters of qwen2-0.5b, 3.24 ms at 3.35 TB/s.  The design:
//   * ONE launch per optimizer step over all leaves.  The Pallas version is
//     called once per leaf (290 leaves for qwen2-0.5b), each padded to
//     (8, 128) tiles; on this card most of those leaves are too small to
//     fill 132 SMs and each launch costs host time.  Here a device table
//     holds each leaf's (p, g, m, v, numel, first chunk); the grid walks
//     (leaf, chunk) pairs, a block finds its leaf by binary search over the
//     table, and the ragged last chunk of a leaf is masked: no padding.
//   * each thread handles 4 consecutive elements per pass, with 16-byte
//     (f32) or 8-byte (bf16) vector accesses where the leaf's four base
//     pointers allow it (a per-leaf flag from the wrapper).
//   * lr, bc1 and bc2 are kernel arguments computed on the host from the
//     host-int step, so no device value is read back.
// Every operation uses the _rn intrinsics (no FMA contraction), so each
// element rounds as the plain version's separate operations do.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).  The
// launch goes on the caller's stream; the function returns the CUDA error of
// the launch (0 on success) or a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int CHUNK = 4096;   // elements per block: 4 passes of 256 x 4

// Mirrors the ctypes/numpy record of repro_torch/kernels/fused_adam.py
// (LEAF_DTYPE): seven 8-byte fields, 56 bytes a leaf.
struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long n;        // elements
  long long chunk0;   // index of the leaf's first chunk in the grid
  // bits 0/1: p / g is bf16; bit 2: all four pointers allow vector access
  long long flags;
};

struct Hyper {
  float lr, bc1, bc2, b1, om_b1, b2, om_b2, eps, wd;
};

__device__ __forceinline__ float ld(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void ld4(const void* p, long long i, bool bf,
                                    float (&x)[VEC]) {
  if (bf) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
    const float4 v =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
}

__device__ __forceinline__ void st(void* p, long long i, bool bf, float x) {
  if (bf) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

__device__ __forceinline__ void st4(void* p, long long i, bool bf,
                                    const float (&x)[VEC]) {
  if (bf) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// One element: (p, g, m, v) -> (p', m', v'), in the plain version's order.
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.om_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.om_b2, g), g));
  float up = __fdiv_rn(__fdiv_rn(m, h.bc1),
                       __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.wd != 0.f) up = __fadd_rn(up, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, up));
}

__global__ void __launch_bounds__(THREADS)
fused_adam(const Leaf* __restrict__ leaves, int L, Hyper h) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = L - 1;   // the last leaf whose chunk0 <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
  }
  const Leaf lf = leaves[lo];
  const bool pbf = lf.flags & 1, gbf = lf.flags & 2, vec = lf.flags & 4;
  const long long begin = (chunk - lf.chunk0) * CHUNK;
  const long long end = min(begin + CHUNK, lf.n);

  for (long long i = begin + threadIdx.x * VEC; i < end;
       i += THREADS * VEC) {
    if (vec && i + VEC <= end) {
      float p[VEC], g[VEC], m[VEC], v[VEC];
      ld4(lf.p, i, pbf, p);
      ld4(lf.g, i, gbf, g);
      ld4(lf.m, i, false, m);
      ld4(lf.v, i, false, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) adam1(p[j], g[j], m[j], v[j], h);
      st4(lf.p, i, pbf, p);
      st4(lf.m, i, false, m);
      st4(lf.v, i, false, v);
    } else {
      for (long long k = i; k < min(i + VEC, end); ++k) {
        float p = ld(lf.p, k, pbf), m = lf.m[k], v = lf.v[k];
        adam1(p, ld(lf.g, k, gbf), m, v, h);
        st(lf.p, k, pbf, p);
        lf.m[k] = m;
        lf.v[k] = v;
      }
    }
  }
}

}  // namespace

// leaves: device table of L Leaf records; n_chunks: the grid (the last
// leaf's chunk0 plus its chunks).  Scalars as in the formula above;
// om_b1 = 1 - b1 and om_b2 = 1 - b2 are passed rounded from double, as the
// plain version rounds the Python float 1 - b1.
extern "C" int fused_adam_step(const void* leaves, int L, long long n_chunks,
                               float lr, float bc1, float bc2, float b1,
                               float om_b1, float b2, float om_b2, float eps,
                               float wd, void* stream) {
  if (L < 1 || n_chunks < 1 || n_chunks > 0x7fffffffLL) return -1;
  const Hyper h{lr, bc1, bc2, b1, om_b1, b2, om_b2, eps, wd};
  fused_adam<<<static_cast<unsigned>(n_chunks), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), L, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_adam_chunk() { return CHUNK; }
