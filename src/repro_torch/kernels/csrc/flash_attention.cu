// Blocked online-softmax GQA attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (entry :93, pallas_call :113, body
// `_kernel` :29).  It computes exactly `reference_attention` of
// src/repro_torch/kernels/ref.py: q (B,Sq,H,hd), k/v (B,Sk,KV,hd), query head
// h reads KV head h / (H/KV), scale 1/sqrt(hd), f32 softmax statistics,
// causal and sliding-window masks on aligned-suffix positions (query row i
// sits at i + Sk - Sq; the Pallas kernel places it at i, which is wrong for
// Sq != Sk), output in q's dtype.
//
// What bounds it on the H100.  At the serving shapes of qwen2-0.5b
// (H=14, KV=2, hd=64, bf16):
//   * decode (Sq=1, Sk<=160, B=4): 7 query rows per KV head read the whole
//     K/V view once.  Bytes bound it: about 0.3 MB at Sk=132, 0.085 us at
//     3.35 TB/s.
//   * prefill (Sq=Sk=128..512, B=4): about 4*B*H*hd*S^2/2 operations against
//     B*S*(2H+2KV)*hd*2 bytes, about 224 operations per byte at S=512
//     against the card's 295 for bf16, so bytes set the roofline up to
//     S=512 and operations above it.
// This first version does its products with f32 FMAs on the CUDA cores, not
// the tensor cores, and every FMA needs one shared-memory load; at Sq=1 only
// the 14 threads of the 7 packed rows of a block work.  So it sits far above
// its bound (measured on the H100: 55 us per decode call, 51 us at prefill
// S=128; PERF.md has every case).  wgmma, TMA, vectorized shared loads and
// split-K decode are later work; chip_smoke.py prints this kernel's time
// beside its bound.
//
// Design.
//   * GQA packing: a block owns one (batch, KV head) and BQ=64 consecutive
//     rows of the (query position, group head) space, row r = i*G + g.  The
//     G query heads that share a KV head read each K/V tile once; decode's
//     Sq=1 fills 7 rows of one block per KV head instead of 7 blocks.
//   * Two threads per row.  Each holds half the head dims (d = half + 2*i)
//     of q and of the output accumulator in registers; a score is the sum of
//     the two halves' partial dots (one shuffle).  Both threads keep the
//     row's running max m and sum l, so no other exchange is needed.
//   * K/V tiles of BK=32 keys are staged in shared memory as f32.  Tiles
//     that no row of the block can see (past the causal edge, before the
//     window) are skipped; the ragged last tile is masked per key, so no
//     length needs to be a multiple of a tile.
//   * Masked keys contribute p = 0 exactly (a validity bit per key), so a
//     row whose first tiles are all masked carries no junk.
//   * Strides are arguments: the decode views cache[:, :pos+1] go in with no
//     copy.  Only the last dimension must be contiguous.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).  The
// launch goes on the caller's stream; the function returns the CUDA error of
// the launch (0 on success) or -1 for a head_dim this build does not cover.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // packed rows per block
constexpr int BK = 32;       // keys per shared-memory tile
constexpr int NT = 2 * BQ;   // two threads per row
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd(Params p) {
  constexpr int HH = HD / 2;   // head dims per thread
  __shared__ float Ks[BK][HD];
  __shared__ float Vs[BK][HD];

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int G = p.H / p.KV;
  const int rows = p.Sq * G;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int r = row0 + (tid >> 1);
  const bool active = r < rows;
  const int rc = active ? r : rows - 1;   // idle rows shadow the last one
  const int qi = rc / G;
  const int h = kvh * G + rc % G;
  const int off = p.Sk - p.Sq;
  const int qpos = qi + off;

  // Keys any row of this block can see.
  const int last = min(rows, row0 + BQ) - 1;
  const int qpos_lo = row0 / G + off;
  const int qpos_hi = last / G + off;
  const int k_end = p.causal ? min(p.Sk, qpos_hi + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;
  k_begin -= k_begin % BK;

  float qr[HH];
  float acc[HH];
  const T* qrow = q + b * p.q_sb + qi * p.q_ss + h * p.q_sh;
#pragma unroll
  for (int i = 0; i < HH; ++i) {
    qr[i] = to_f32(qrow[half + 2 * i]);
    acc[i] = 0.f;
  }
  float m = NEG;
  float l = 0.f;

  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < k_end) {
        kx = to_f32(kb[kp * p.k_ss + d]);
        vx = to_f32(vb[kp * p.v_ss + d]);
      }
      Ks[j][d] = kx;
      Vs[j][d] = vx;
    }
    __syncthreads();

    float s[BK];
    unsigned valid = 0u;
    float mt = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < HH; ++i) part = fmaf(qr[i], Ks[j][half + 2 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kp = k0 + j;
      const bool ok = kp < k_end && (!p.causal || kp <= qpos) &&
                      (p.window <= 0 || kp > qpos - p.window);
      s[j] = part * p.scale;
      if (ok) {
        valid |= 1u << j;
        mt = fmaxf(mt, s[j]);
      }
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < HH; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float pj = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      l += pj;
#pragma unroll
      for (int i = 0; i < HH; ++i) acc[i] = fmaf(pj, Vs[j][half + 2 * i], acc[i]);
    }
    m = m_new;
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + b * p.o_sb + qi * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < HH; ++i) store(orow + half + 2 * i, acc[i] * inv);
  }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  const int rows = p.Sq * (p.H / p.KV);
  const dim3 grid((rows + BQ - 1) / BQ, p.KV, p.B);
  flash_fwd<T, HD><<<grid, NT, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, void* stream) {
  Params p{q, k, v, o, B, Sq, Sk, H, KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, hd, st);
  if (dtype == 0) return dispatch<float>(p, hd, st);
  return -2;
}
