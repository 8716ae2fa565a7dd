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
// Rows are packed as in the Pallas kernel's GQA layout: for one (batch, KV
// head), row r = i*G + g is query position i of the group's head g, so the
// G query heads that share a KV head read each K/V tile once.  Strides are
// arguments (cache views go in with no copy); only the last dimension must
// be contiguous.  Decode passes the whole padded cache and its key count
// as a device int (`Params::len`), so one CUDA graph of a decode step
// serves every position: the CUDA-core and split paths read the count and
// derive the query position and the visible keys from it.
//
// Three paths; the wrapper (flash_attention.py `choose_path`) picks one by
// dtype, the number of packed rows and the 16-byte alignment of the inputs:
//
// 1. wgmma (`flash_fwd_tc`): bf16, more than 64 packed rows (prefill, the
//    train forward).  What bounds it on the H100: at qwen2-0.5b's shapes
//    (hd 64, G 7) about 224 operations per byte at S = 512 against the
//    card's 295 for bf16, so bytes up to S ~ 512 and the tensor cores above;
//    at S = 128 neither: a few microseconds of latency.  Design: one
//    warpgroup per block owns 64 packed rows; its Q fragments stay in
//    registers for the whole key loop.  K/V tiles of 64 keys are copied by
//    16-byte cp.async into a two-stage ring in the 128-byte swizzled bf16
//    layout that wgmma reads, the next tile's copy in flight during this
//    tile's products.  S = Q K^T is wgmma m64n64k16 (K the K-major B
//    operand), the scale, masks and online softmax run on the f32
//    accumulator fragments (row max and sum over the 4 lanes that share a
//    row), P is rounded to bf16 in registers and is the register A operand
//    of O += P V (wgmma m64n{hd}k16, V the MN-major B operand); O stays f32
//    in registers.  Per-element masks only on tiles that cross the causal
//    edge, the window start or the ragged end; tiles no row sees are
//    skipped; row blocks with the most keys start first.
// 2. split-KV (`flash_split_tc` + `flash_combine`): bf16, at most 64
//    packed rows (decode: Sq = 1, 7 rows).  Bytes bound it (the K/V view
//    is read once, 0.3 MB at Sk = 132), but one block per (batch, KV head)
//    would leave 124 of 132 SMs idle at B*KV = 8 and walk the keys in a
//    row, so the wrapper's `split_plan` cuts them into ranges of 32 to 256
//    keys: a grid of (splits, KV x 16-row tiles, B) blocks.  A block copies 64-key K/V tiles by 16-byte cp.async into a
//    two-stage ring (the next tile in flight), keeps an online softmax per
//    row and writes f32 partials (acc[hd], m, l) to a scratch tensor the
//    wrapper allocates; `flash_combine` merges them, one block a row, in
//    one round trip to memory for up to 8 splits.  With one split the
//    first kernel writes the output itself.  A block's time is the latency
//    of its chain of steps, not bytes, so the steps are kept few: a 16-row
//    tile of the packed rows (7 real at decode) against each warp's 16 keys
//    of a tile by mma.sync m16n8k16 (ldmatrix from padded rows), P rounded
//    to bf16 in registers as the A operand of P V; the four warps' partials
//    merge in shared memory.
// 3. CUDA cores (`flash_fwd`): f32 at any shape (only the parity runs use
//    f32, held at 2e-5, which neither bf16 tensor cores nor TF32 can hold;
//    their decode is one batch row, so a split would buy nothing the
//    timed paths need), and inputs not 16-byte aligned.  Two threads per
//    row, f32 FMAs, K/V tiles staged in shared memory as f32.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).
// Launches go on the caller's stream; the function returns the CUDA error
// of its launches (0 on success), -1 for a head_dim this build does not
// cover, -2 for a dtype, -3 for a path that does not take the shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;       // packed rows per block (CUDA-core path)
constexpr int BK = 32;       // keys per shared-memory tile (CUDA-core path)
constexpr int NT = 2 * BQ;   // two threads per row
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TC_ROWS = 64;      // packed rows per block: one warpgroup
constexpr int TC_KEYS = 64;      // keys per K/V tile
constexpr int TC_THREADS = 128;

constexpr int SP_ROWS = 64;      // most packed rows the split path takes
constexpr int SP_MAX_SPLITS = 64;  // the combine's threads read one each
constexpr int ST_ROWS = 16;      // split path on tensor cores: a row tile,
constexpr int ST_KEYS = 64;      // keys a K/V tile,
constexpr int ST_WARPS = 4;      // 16 keys a warp
constexpr int ST_THREADS = 32 * ST_WARPS;

enum Path { PATH_SIMT = 0, PATH_WGMMA = 1, PATH_SPLIT = 2 };

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
  // split path: keys [k_begin, k_end) in `splits` ranges of `chunk` keys;
  // with more than one split, `part` holds their partials
  int k_begin, k_end, chunk, splits;
  float* part;
  // the key count on the device (decode under a CUDA graph: one capture
  // serves every cache length); null takes Sk and [k_begin, k_end) above
  const int* len;
};

// The keys this call attends over: Sk, or the device's count when set.
__device__ __forceinline__ int key_count(const Params& p) {
  return p.len ? *p.len : p.Sk;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ bool visible(int kp, int qpos, int causal,
                                        int window) {
  return (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
}

// ---------------------------------------------------------------------------
// Path 3: CUDA cores.
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
  const int Sk = key_count(p);
  const int off = Sk - p.Sq;
  const int qpos = qi + off;

  // Keys any row of this block can see.
  const int last = min(rows, row0 + BQ) - 1;
  const int qpos_lo = row0 / G + off;
  const int qpos_hi = last / G + off;
  const int k_end = p.causal ? min(Sk, qpos_hi + 1) : Sk;
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

// ---------------------------------------------------------------------------
// Path 1: tensor cores (wgmma), bf16.

template <int HD>
struct TcShape {
  static constexpr int ATOMS = HD / 64;                // 64-wide column blocks
  static constexpr int BLOCK = TC_KEYS * 128;          // bytes of one block
  static constexpr int TILE = ATOMS * BLOCK;           // one K or V tile
  static constexpr int STAGE = 2 * TILE;               // K and V
  static constexpr int SMEM = 2 * STAGE + 1024;        // two stages + align
  static constexpr int CHUNKS = TC_KEYS * HD / 8;      // 16-byte chunks a tile
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_tc(Params p) {
  using S = TcShape<HD>;
  extern __shared__ uint8_t smem_raw[];
  // wgmma's swizzle reads address bits 7-9: atoms start on 1024 bytes
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const __nv_bfloat16* __restrict__ q =
      static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* __restrict__ k =
      static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* __restrict__ v =
      static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* __restrict__ o = static_cast<__nv_bfloat16*>(p.o);

  const int G = p.H / p.KV;
  const int rows = p.Sq * G;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  // causal: the last row blocks see the most keys; start them first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int off = p.Sk - p.Sq;

  // This thread's two rows of the accumulator layout: warp*16 + lane/4 and
  // 8 below it.
  int r_[2], qpos[2];
  bool act[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row0 + warp * 16 + (lane >> 2) + 8 * h2;
    act[h2] = r < rows;
    const int rc = act[h2] ? r : rows - 1;
    const int qi = rc / G;
    r_[h2] = rc;
    qpos[h2] = qi + off;
    qrow[h2] = q + b * p.q_sb + qi * p.q_ss + (kvh * G + rc % G) * p.q_sh;
  }

  // Keys any row of this block can see, from a 64-aligned start.
  const int last = min(rows, row0 + TC_ROWS) - 1;
  const int qpos_first = row0 / G + off;
  const int qpos_last = last / G + off;
  const int k_end = p.causal ? min(p.Sk, qpos_last + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, qpos_first - p.window + 1) : 0;
  k_begin -= k_begin % TC_KEYS;
  const int n_tiles = (k_end - k_begin + TC_KEYS - 1) / TC_KEYS;

  // Q as the register A operand: per 16-wide k step, rows (r, r+8) x
  // columns (2*quad, 2*quad + 8) of the step, two bf16 in each register.
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * quad;
    qa[kk][0] = act[0] ? *reinterpret_cast<const uint32_t*>(qrow[0] + c) : 0u;
    qa[kk][1] = act[1] ? *reinterpret_cast<const uint32_t*>(qrow[1] + c) : 0u;
    qa[kk][2] =
        act[0] ? *reinterpret_cast<const uint32_t*>(qrow[0] + c + 8) : 0u;
    qa[kk][3] =
        act[1] ? *reinterpret_cast<const uint32_t*>(qrow[1] + c + 8) : 0u;
  }

  const __nv_bfloat16* kb = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + kvh * p.v_sh;

  // One K/V tile into a stage: 16-byte chunks, neighbouring threads on
  // neighbouring chunks of a key row; keys at or past k_end are zeros.
  auto load_tile = [&](int k0, int stage) {
    const uint32_t ks = base + stage * S::STAGE;
    const uint32_t vs = ks + S::TILE;
#pragma unroll
    for (int i = 0; i < S::CHUNKS / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS;
      const int row = idx / (HD / 8);
      const int c = idx % (HD / 8);
      const uint32_t dst =
          (c >> 3) * S::BLOCK + hopper::swizzle128(row, c & 7);
      const int kp = k0 + row;
      const bool ok = kp < k_end;
      const long long kpc = ok ? kp : 0;
      hopper::cp_async16(ks + dst, kb + kpc * p.k_ss + c * 8, ok ? 16 : 0);
      hopper::cp_async16(vs + dst, vb + kpc * p.v_ss + c * 8, ok ? 16 : 0);
    }
  };

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums
  const float sl2 = p.scale * LOG2E;

  load_tile(k_begin, 0);
  hopper::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * TC_KEYS;
    if (t + 1 < n_tiles) {
      load_tile(k0 + TC_KEYS, (t + 1) & 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();
    const uint32_t ks = base + (t & 1) * S::STAGE;
    const uint32_t vs = ks + S::TILE;

    // S = Q K^T: 64 rows x 64 keys, K the K-major B operand.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t desc = hopper::make_desc(
          ks + (kk >> 2) * S::BLOCK + (kk & 3) * 32, 16, 1024);
      hopper::wgmma_m64n64k16_rs<0>(s, qa[kk], desc, kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);

    // s[4j + 2h + c] is row r_[h], key k0 + 8j + 2*quad + c.
    const bool need_mask = k0 + TC_KEYS > p.Sk ||
                           (p.causal && k0 + TC_KEYS - 1 > qpos_first) ||
                           (p.window > 0 && k0 <= qpos_last - p.window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kp = k0 + 8 * j + 2 * quad + c;
            if (kp >= p.Sk || !visible(kp, qpos[h2], p.causal, p.window))
              s[4 * j + 2 * h2 + c] = -INFINITY;
          }
    }

    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h2], s[4 * j + 2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx * sl2);
      // a row that has seen no key yet keeps p = 0 and corr = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      corr[h2] = exp2f(m[h2] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h2 + c;
          s[i] = exp2f(fmaf(s[i], sl2, -m_use));
          sum += s[i];
        }
      l[h2] = l[h2] * corr[h2] + sum;
      m[h2] = m_new;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }

    // P (bf16) as the register A operand, 16 keys a step: the S fragment
    // of keys 16kk..16kk+15 is the A fragment of that k step.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V: V the MN-major B operand, 16 keys (2048 bytes) a step.
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc =
          hopper::make_desc(vs + kk * 16 * 128, S::BLOCK, 1024);
      if constexpr (HD == 64)
        hopper::wgmma_m64n64k16_rs<1>(acc, pa[kk], desc, 1);
      else
        hopper::wgmma_m64n128k16_rs<1>(acc, pa[kk], desc, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    __syncthreads();   // this stage is read; the next loop may refill it
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float sum = l[h2];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (!act[h2]) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int rc = r_[h2];
    __nv_bfloat16* orow = o + b * p.o_sb + (rc / G) * p.o_ss +
                          (kvh * G + rc % G) * p.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          acc[4 * j + 2 * h2] * inv, acc[4 * j + 2 * h2 + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * quad) = x;
    }
  }
}

// ---------------------------------------------------------------------------
// Path 2: split-KV on tensor cores (bf16), at most 64 packed rows: one
// 16-row tile of packed rows a block, the four warps taking 16 keys each of
// every 64-key tile.
template <int HD>
struct SplitTcShape {
  static constexpr int LD = HD + 8;   // bf16 row pitch: 16-byte aligned,
                                      // ldmatrix rows on distinct banks
  static constexpr int TILE = ST_KEYS * LD * 2;          // bytes, K or V
  static constexpr int STAGE = 2 * TILE;
  static constexpr int Q = 2 * STAGE;                    // after the ring
  static constexpr int SMEM = Q + ST_ROWS * LD * 2;
  // after the loop the ring holds each warp's (m, l, acc), f32
  static constexpr int W_FLOATS = ST_WARPS * ST_ROWS * (HD + 2);
  static_assert(W_FLOATS * 4 <= 2 * STAGE, "merge area fits the ring");
};

template <int HD>
__global__ void __launch_bounds__(ST_THREADS) flash_split_tc(Params p) {
  using S = SplitTcShape<HD>;
  extern __shared__ __align__(16) uint8_t st_smem[];
  const uint32_t base = hopper::smem_addr(st_smem);
  const int G = p.H / p.KV;
  const int R = p.Sq * G;
  const int n_mt = (R + ST_ROWS - 1) / ST_ROWS;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_mt;
  const int r0 = (blockIdx.y % n_mt) * ST_ROWS;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // With the key count on the device, the host's plan fixes only the
  // grid (`splits` ranges of `chunk` keys, sized for the padded cache) and
  // the visible keys [k_begin, k_end) follow from the count here, as
  // `key_range` computes them on the host; a split past them is empty.
  const int Sk = key_count(p);
  int k_begin = p.k_begin, k_end = p.k_end;
  if (p.len) {
    k_end = Sk;
    k_begin = p.window > 0 ? max(0, Sk - p.Sq - p.window + 1) : 0;
  }
  const int off = Sk - p.Sq;
  const int ks0 = k_begin + split * p.chunk;
  const int ke0 = min(k_end, ks0 + p.chunk);
  const int n_tiles = max(0, (ke0 - ks0 + ST_KEYS - 1) / ST_KEYS);
  const float sl2 = p.scale * LOG2E;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the row tile of q, rows past R zeros
  for (int idx = tid; idx < ST_ROWS * (HD / 8); idx += ST_THREADS) {
    const int i = idx / (HD / 8);
    const int c = idx % (HD / 8);
    const int r = min(r0 + i, R - 1);
    hopper::cp_async16(base + S::Q + (i * S::LD + c * 8) * 2,
                       q + b * p.q_sb + (r / G) * p.q_ss +
                           (kvh * G + r % G) * p.q_sh + c * 8,
                       r0 + i < R ? 16 : 0);
  }
  auto load_tile = [&](int k0, int stage) {
    const uint32_t ks = base + stage * S::STAGE;
#pragma unroll
    for (int i = 0; i < ST_KEYS * HD / 8 / ST_THREADS; ++i) {
      const int idx = tid + i * ST_THREADS;
      const int row = idx / (HD / 8);
      const int c = idx % (HD / 8);
      const bool ok = k0 + row < ke0;
      const long long kp = ok ? k0 + row : ks0;
      const uint32_t dst = (row * S::LD + c * 8) * 2;
      hopper::cp_async16(ks + dst, kb + kp * p.k_ss + c * 8, ok ? 16 : 0);
      hopper::cp_async16(ks + S::TILE + dst, vb + kp * p.v_ss + c * 8,
                         ok ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(ks0, 0);
  hopper::cp_async_commit();
  if (n_tiles == 0) hopper::cp_async_wait<0>();   // q's copies land

  // this thread's rows of the accumulator layout: g and g + 8
  int qpos[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    live[h] = r < R;
    qpos[h] = min(r, R - 1) / G + off;
  }
  uint32_t qa[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's share

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = ks0 + t * ST_KEYS;
    if (t + 1 < n_tiles) {
      load_tile(k0 + ST_KEYS, (t + 1) & 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::ldsm_x4(base + S::Q + ((lane & 15) * S::LD + kk * 16 +
                                       (lane >> 4) * 8) * 2, qa[kk]);
    }
    const uint32_t ks = base + (t & 1) * S::STAGE;
    const uint32_t vs = ks + S::TILE;
    const int kw = 16 * warp;   // this warp's keys in the tile

    // S = Q K^T: 16 rows x 16 keys, two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t bk[4];
      hopper::ldsm_x4(ks + ((kw + (lane & 7) + (lane >> 4) * 8) * S::LD +
                            kk * 16 + ((lane >> 3) & 1) * 8) * 2, bk);
      hopper::mma_bf16(s[0], qa[kk], bk[0], bk[1]);
      hopper::mma_bf16(s[1], qa[kk], bk[2], bk[3]);
    }
    // s[n][2h + c]: row g + 8h, key k0 + kw + 8n + 2*t4 + c
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = k0 + kw + 8 * n + 2 * t4 + c;
          float& x = s[n][2 * h + c];
          x = live[h] && kp < ke0 && visible(kp, qpos[h], p.causal, p.window)
                  ? x * sl2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = exp2f(m[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * h + c];
          x = exp2f(x - m_use);
          sum += x;
        }
      l[h] = l[h] * corr[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // O += P V: P (bf16) is the A fragment of the warp's 16 keys
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint32_t bv[4];
      hopper::ldsm_x4_t(vs + ((kw + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  S::LD + j * 16 + (lane >> 4) * 8) * 2, bv);
      hopper::mma_bf16(acc[2 * j], pa, bv[0], bv[1]);
      hopper::mma_bf16(acc[2 * j + 1], pa, bv[2], bv[3]);
    }
    __syncthreads();   // this stage is read; the next loop may refill it
  }

  // each warp's (m, l, acc) into the ring, then merged over the warps
  float* wm = reinterpret_cast<float*>(st_smem);
  float* wl = wm + ST_WARPS * ST_ROWS;
  float* wacc = wl + ST_WARPS * ST_ROWS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int i = g + 8 * h;
    if (t4 == 0) {
      wm[warp * ST_ROWS + i] = m[h];
      wl[warp * ST_ROWS + i] = lh;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float* dst = wacc + (warp * ST_ROWS + i) * HD + 8 * j + 2 * t4;
      dst[0] = acc[j][2 * h];
      dst[1] = acc[j][2 * h + 1];
    }
  }
  __syncthreads();

  const int nr = min(ST_ROWS, R - r0);
  const long long bk = (long long)b * p.KV + kvh;
  const long long slot = (bk * p.splits + split) * R + r0;
  const long long n_acc = (long long)p.B * p.KV * p.splits * R * HD;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  for (int idx = tid; idx < nr * HD; idx += ST_THREADS) {
    const int i = idx / HD;
    const int d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < ST_WARPS; ++w) M = fmaxf(M, wm[w * ST_ROWS + i]);
    const float m_use = M == -INFINITY ? 0.f : M;
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < ST_WARPS; ++w) {
      const float e = exp2f(wm[w * ST_ROWS + i] - m_use);
      a = fmaf(e, wacc[(w * ST_ROWS + i) * HD + d], a);
      lsum = fmaf(e, wl[w * ST_ROWS + i], lsum);
    }
    if (p.splits == 1) {   // one split: the output itself
      const int r = r0 + i;
      store(o + b * p.o_sb + (r / G) * p.o_ss + (kvh * G + r % G) * p.o_sh +
                d, lsum > 0.f ? a / lsum : 0.f);
    } else {
      p.part[(slot + i) * HD + d] = a;
      if (d == 0) {
        p.part[n_acc + 2 * (slot + i)] = M;
        p.part[n_acc + 2 * (slot + i) + 1] = lsum;
      }
    }
  }
}

// Merge the splits' partials: grid (R, KV, B), one thread a head dim.
// Thread s < splits loads that split's (m, l) into shared memory while
// every thread loads the accumulators of its dim of the first CB_PRE
// splits, so up to CB_PRE splits cost one round trip to memory; each
// thread then weighs the splits by exp2(m_s - max m) itself.
constexpr int CB_PRE = 8;

template <int HD>
__global__ void __launch_bounds__(HD) flash_combine(Params p) {
  __shared__ float ms[SP_MAX_SPLITS], ls[SP_MAX_SPLITS];
  const int G = p.H / p.KV;
  const int R = p.Sq * G;
  const int r = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int ns = p.splits;
  const long long row0 = ((long long)b * p.KV + kvh) * ns * R + r;
  const long long stride = (long long)R * HD;   // split to split
  const float* pml = p.part + (long long)p.B * p.KV * ns * R * HD;
  const float* pacc = p.part + row0 * HD + d;

  float pre[CB_PRE];
#pragma unroll
  for (int s = 0; s < CB_PRE; ++s) pre[s] = s < ns ? pacc[s * stride] : 0.f;
  if (d < ns) {
    ms[d] = pml[2 * (row0 + (long long)d * R)];
    ls[d] = pml[2 * (row0 + (long long)d * R) + 1];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, ms[s]);
  const float m_use = M == -INFINITY ? 0.f : M;
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int s = 0; s < CB_PRE; ++s) {
    if (s < ns) {
      const float w = exp2f(ms[s] - m_use);
      num = fmaf(w, pre[s], num);
      den = fmaf(w, ls[s], den);
    }
  }
#pragma unroll 8
  for (int s = CB_PRE; s < ns; ++s) {
    const float w = exp2f(ms[s] - m_use);
    num = fmaf(w, pacc[s * stride], num);
    den = fmaf(w, ls[s], den);
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  store(o + b * p.o_sb + (r / G) * p.o_ss + (kvh * G + r % G) * p.o_sh + d,
        den > 0.f ? num / den : 0.f);
}

// ---------------------------------------------------------------------------
// Launches.

// Raise a kernel's dynamic shared-memory ceiling once; 0 or the CUDA error.
template <typename K>
int allow_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <typename T, int HD>
int launch(const Params& p, int path, cudaStream_t stream) {
  const int rows = p.Sq * (p.H / p.KV);
  if (path == PATH_SIMT) {
    const dim3 grid((rows + BQ - 1) / BQ, p.KV, p.B);
    flash_fwd<T, HD><<<grid, NT, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (sizeof(T) == 2) {
    if (path == PATH_SPLIT) {
      if (rows > SP_ROWS || p.splits < 1 || p.splits > SP_MAX_SPLITS ||
          (p.splits > 1 && !p.part))
        return -3;
      using ST = SplitTcShape<HD>;
      static bool allowed = false;
      const int err = allow_smem(flash_split_tc<HD>, ST::SMEM, allowed);
      if (err) return err;
      const int n_mt = (rows + ST_ROWS - 1) / ST_ROWS;
      flash_split_tc<HD><<<dim3(p.splits, p.KV * n_mt, p.B), ST_THREADS,
                           ST::SMEM, stream>>>(p);
      if (p.splits > 1)
        flash_combine<HD><<<dim3(rows, p.KV, p.B), HD, 0, stream>>>(p);
      return static_cast<int>(cudaGetLastError());
    }
    if (path == PATH_WGMMA) {
      if (p.len) return -3;
      using S = TcShape<HD>;
      static bool allowed = false;
      const int err = allow_smem(flash_fwd_tc<HD>, S::SMEM, allowed);
      if (err) return err;
      const dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, p.KV, p.B);
      flash_fwd_tc<HD><<<grid, TC_THREADS, S::SMEM, stream>>>(p);
      return static_cast<int>(cudaGetLastError());
    }
  }
  return -3;
}

template <typename T>
int dispatch(const Params& p, int hd, int path, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, path, stream);
    case 128: return launch<T, 128>(p, path, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  path: 0 CUDA cores, 1 wgmma (bf16),
// 2 split-KV (bf16).  Strides are in elements.  The split path reads keys
// [k_begin, k_end) in `splits` ranges of `chunk` keys and, with more than
// one split, keeps its partials in `part` (B*KV*splits*rows*(hd+2) f32).
// `len`, when not null, is a device int32: the keys are its first `*len`
// slots of the Sk given, query row i sits at i + *len - Sq, and the split
// path's plan covers at most Sk keys (min(Sk, window + Sq - 1) windowed)
// from the visible range's start; the wgmma path takes no `len` (-3).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, int path, int k_begin, int k_end,
    int chunk, int splits, void* part, const void* len, void* stream) {
  Params p{q, k, v, o, B, Sq, Sk, H, KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, causal, window, scale,
           k_begin, k_end, chunk, splits, static_cast<float*>(part),
           static_cast<const int*>(len)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, hd, path, st);
  if (dtype == 0) return dispatch<float>(p, hd, path, st);
  return -2;
}
