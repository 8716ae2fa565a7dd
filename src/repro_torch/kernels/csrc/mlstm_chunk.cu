// Chunkwise stabilized mLSTM (matrix-memory linear attention with exponential
// gates) for Hopper (sm_90a), forward, with the final recurrence state.
//
// Replaces the Pallas TPU kernel `mlstm_chunk` in
// src/repro/kernels/mlstm_chunk.py (entry :87, pallas_call :103, body
// `_kernel` :26).  It computes what that kernel computes, the normalized
// recurrence h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t)) with scale
// 1/sqrt(hd), in the same chunkwise form: per chunk the log-gate matrix
// D[t,s] = lg_t - lg_s + i_s (s <= t), m_out = max(lg + m_prev, max_s D),
// W = exp(D - m_out), y = (W*(q k^T)) v + exp(lg + m_prev - m_out) q C, and
// the carried state C, n, m updated once at the chunk's end.  It also
// returns the final state (loga, m, C, n), which the Pallas kernel drops:
// prefill hands it to decode as the cache.  Any S (the last chunk may be
// short) and any B*H; hd 16, 32, or a multiple of 64 up to 512.
//
// Inputs: q/k/v (B,S,H,hd) in f32 or bf16, any strides with hd contiguous;
// g/i (B,S,H) f32 log forget/input gates, any strides.  Outputs, contiguous
// f32: y (B,S,H,hd), C (B,H,hd,hd), n (B,H,hd), m (B,H), loga (B,H).
// Accumulation is f32 throughout; m starts at -1e30, as in JAX.
//
// What bounds it on the H100.  At xlstm-350m's serving shape (B=4, S=128,
// H=4, hd=512, bf16) the chunk algorithm does about 2.3 GFLOP (the q C and
// C update products, 2*S*hd*hd each per head, dominate) against about 24 MB
// of traffic (the 16.8 MB final C is most of it): operations bound it,
// about 34 us at the 67 TFLOP/s of f32 on the CUDA cores, against about
// 7 us for the bytes.
//
// Design. The TPU kernel keeps one head's whole (hd, hd) f32 memory in VMEM;
// at hd = 512 that is 1 MiB, and an SM has 228 KB of shared memory. So the
// value dimension is split: a block owns one (batch, head) and a tile of VT =
// min(64, hd) value columns, keeps C[:, tile] (hd x VT f32, 128 KB at hd 512;
// 178 KB of shared memory in all) and its own copy of n, and walks the chunks
// of CH = 32 positions in order. What reduces over the key dimension (the
// gate matrix, m_out, q k^T, q n, the denominator) does not depend on the
// value tile, and every block of a head recomputes it (redundant by hd/VT,
// about a quarter more arithmetic at hd 512) instead of a first pass writing
// it per chunk: one kernel, no scratch in device memory.
// Per chunk the key dimension is walked in tiles of DT = min(64, hd) rows:
// each q/k tile is read once and feeds q k^T, q n, q C (with the entering
// C) and then the C and n update of the same rows, so C never leaves shared
// memory.  The next tile is loaded into registers while the current one is
// multiplied.  Products are f32 FMAs on the CUDA cores from register tiles
// (2x2 for q k^T, 4x2 for q C, 4x4 for the C update) fed by 8- and 16-byte
// shared loads, so a warp makes one shared load per 4-8 FMAs, not one per
// FMA.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, at the
// serve shape: 0.24 ms of device time against the plain version's 0.42 ms
// and a 0.029 ms bound (a first version with one shared load per FMA took
// 0.52 ms); with 8 warps an SM hides little of the shared-load latency.
// wgmma (bf16 q and k), TMA and more warps per SM are later work.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).  The
// launch goes on the caller's stream; the function returns the CUDA error of
// the launch (0 on success) or a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;          // positions per chunk
constexpr int NT = 256;         // threads per block
constexpr int TMAX = 64;        // widest value tile / key tile
constexpr int MAX_HD = 512;
constexpr int QS = CH + 4;      // row of a key-major q/k tile (16 B aligned)
constexpr int LD_PER = CH * TMAX / NT;   // q/k tile elements a thread loads
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* i;
  float* y;
  float* C;
  float* n;
  float* m;
  float* loga;
  int B, S, H, hd, vt;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long i_sb, i_ss, i_sh;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Floats of dynamic shared memory a block needs; every array starts 16 B
// aligned (each size is a multiple of 4 floats).
__host__ __device__ inline int smem_floats(int hd, int vt) {
  const int dt = vt;
  return hd * vt              // C[:, tile]
         + hd                 // n
         + 2 * dt * QS        // q and k tiles, key-major
         + CH * (dt + 4)      // k tile, position-major
         + 2 * CH * vt        // v tile, and v tile times the carry weight
         + CH * (CH + 4)      // W, then W * (q k^T)
         + 7 * CH             // lg, i, sc, sc_e, m_out, q.n, den
         + 4;                 // m_prev, loga, decay, m_new
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) mlstm_fwd(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int hd = p.hd;
  const int VT = p.vt;
  const int DT = p.vt;
  const int KSS = DT + 4;   // row of the position-major k tile
  const int nvt = hd / VT;
  int blk = blockIdx.x;
  const int vti = blk % nvt;
  blk /= nvt;
  const int h = blk % p.H;
  const int b = blk / p.H;
  const int v0 = vti * VT;
  const int tid = threadIdx.x;

  float* Cs = smem;                    // [hd][VT]
  float* ns = Cs + hd * VT;            // [hd]
  float* QT = ns + hd;                 // [DT][QS], scaled q
  float* KT = QT + DT * QS;            // [DT][QS]
  float* KS = KT + DT * QS;            // [CH][KSS]
  float* Vs = KS + CH * KSS;           // [CH][VT]
  float* Vsc = Vs + CH * VT;           // [CH][VT], v * sc
  float* Wm = Vsc + CH * VT;           // [CH][CH+4]
  float* lg = Wm + CH * (CH + 4);
  float* ig = lg + CH;
  float* sc = ig + CH;
  float* sce = sc + CH;
  float* mo = sce + CH;
  float* qn = mo + CH;
  float* den = qn + CH;
  float* scal = den + CH;   // [0] m_prev, [1] loga, [2] decay, [3] m_new

  const T* __restrict__ q =
      static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* __restrict__ k =
      static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* __restrict__ v =
      static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* __restrict__ gp = p.g + b * p.g_sb + h * p.g_sh;
  const float* __restrict__ ip = p.i + b * p.i_sb + h * p.i_sh;

  for (int idx = tid; idx < hd * VT; idx += NT) Cs[idx] = 0.f;
  for (int idx = tid; idx < hd; idx += NT) ns[idx] = 0.f;
  if (tid == 0) {
    scal[0] = NEG;
    scal[1] = 0.f;
  }
  __syncthreads();

  // Register tiles.  q k^T: 2 rows t x 2 keys s per thread (all threads).
  const int kt0 = 2 * (tid / (CH / 2));
  const int ks0 = 2 * (tid % (CH / 2));
  // q C and the outputs: 4 rows t x 2 value columns j, (CH/4)*(VT/2)
  // threads; a warp shares its rows, so the q loads are broadcasts.
  const bool c_on = tid < (CH / 4) * (VT / 2);
  const int ct0 = 4 * (tid / (VT / 2));
  const int cj0 = 2 * (tid % (VT / 2));
  // C update: 4 key rows d x 4 value columns j, (DT/4)*(VT/4) threads.
  const bool u_on = tid < (DT / 4) * (VT / 4);
  const int ud0 = 4 * (tid / (VT / 4));
  const int uj0 = 4 * (tid % (VT / 4));
  const int ld_n = CH * DT;   // q/k tile elements

  for (int c0 = 0; c0 < p.S; c0 += CH) {
    const int L = min(CH, p.S - c0);

    // ---- gates: within-chunk cumulative decay, carry weights, m ----
    if (tid < L) {
      lg[tid] = gp[(long long)(c0 + tid) * p.g_ss];
      ig[tid] = ip[(long long)(c0 + tid) * p.i_ss];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int s = 0; s < L; ++s) {
        acc += lg[s];
        lg[s] = acc;
      }
      const float tot = acc;
      const float m_prev = scal[0];
      float m_loc = NEG;
      for (int s = 0; s < L; ++s) m_loc = fmaxf(m_loc, tot - lg[s] + ig[s]);
      const float m_new = fmaxf(m_prev + tot, m_loc);
      scal[2] = expf(m_prev + tot - m_new);
      scal[3] = m_new;
    }
    __syncthreads();
    const float m_prev = scal[0];
    const float tot = lg[L - 1];
    const float decay = scal[2];
    const float m_new = scal[3];
    if (tid < L) {
      const int t = tid;
      const float lt = lg[t];
      float mi = NEG;
      for (int s = 0; s <= t; ++s) mi = fmaxf(mi, lt - lg[s] + ig[s]);
      const float lge = lt + m_prev;
      const float mout = fmaxf(lge, mi);
      mo[t] = mout;
      sce[t] = expf(lge - mout);
      sc[t] = expf(tot - lt + ig[t] - m_new);
    } else if (tid < CH) {
      sc[tid] = 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < CH * CH; idx += NT) {
      const int t = idx / CH, s = idx % CH;
      Wm[t * (CH + 4) + s] =
          (t < L && s <= t) ? expf(lg[t] - lg[s] + ig[s] - mo[t]) : 0.f;
    }
    for (int idx = tid; idx < CH * VT; idx += NT) {
      const int s = idx / VT, j = idx % VT;
      const float x = s < L ? to_f32(v[(long long)(c0 + s) * p.v_ss + v0 + j])
                            : 0.f;
      Vs[idx] = x;
      Vsc[idx] = x * sc[s];
    }

    float aqk[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float aqc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    float aqn = 0.f;

    // the first q/k tile of the chunk, into registers
    float pq[LD_PER], pk[LD_PER];
    auto fetch = [&](int d0) {
#pragma unroll
      for (int r = 0; r < LD_PER; ++r) {
        const int idx = tid + r * NT;
        const int s = idx / DT, d = idx % DT;
        pq[r] = pk[r] = 0.f;
        if (idx < ld_n && s < L) {
          pq[r] = to_f32(q[(long long)(c0 + s) * p.q_ss + d0 + d]) * p.scale;
          pk[r] = to_f32(k[(long long)(c0 + s) * p.k_ss + d0 + d]);
        }
      }
    };
    fetch(0);

    for (int d0 = 0; d0 < hd; d0 += DT) {
      __syncthreads();   // the previous tile's readers are done
#pragma unroll
      for (int r = 0; r < LD_PER; ++r) {
        const int idx = tid + r * NT;
        if (idx < ld_n) {
          const int s = idx / DT, d = idx % DT;
          QT[d * QS + s] = pq[r];
          KT[d * QS + s] = pk[r];
          KS[s * KSS + d] = pk[r];
        }
      }
      __syncthreads();
      if (d0 + DT < hd) fetch(d0 + DT);   // in flight during the products
      // q k^T
      for (int d = 0; d < DT; ++d) {
        const float2 a = *reinterpret_cast<const float2*>(&QT[d * QS + kt0]);
        const float2 c = *reinterpret_cast<const float2*>(&KT[d * QS + ks0]);
        aqk[0][0] += a.x * c.x;
        aqk[0][1] += a.x * c.y;
        aqk[1][0] += a.y * c.x;
        aqk[1][1] += a.y * c.y;
      }
      // q C with the entering C rows of this tile
      if (c_on) {
        for (int d = 0; d < DT; ++d) {
          const float4 a = *reinterpret_cast<const float4*>(&QT[d * QS + ct0]);
          const float2 c =
              *reinterpret_cast<const float2*>(&Cs[(d0 + d) * VT + cj0]);
          aqc[0][0] += a.x * c.x;
          aqc[0][1] += a.x * c.y;
          aqc[1][0] += a.y * c.x;
          aqc[1][1] += a.y * c.y;
          aqc[2][0] += a.z * c.x;
          aqc[2][1] += a.z * c.y;
          aqc[3][0] += a.w * c.x;
          aqc[3][1] += a.w * c.y;
        }
      }
      // q n
      if (tid < CH)
        for (int d = 0; d < DT; ++d) aqn += QT[d * QS + tid] * ns[d0 + d];
      __syncthreads();
      // C and n update of this tile's rows: decay, then the chunk's k v^T
      if (u_on) {
        float acc[4][4] = {};
        for (int s = 0; s < L; ++s) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&KS[s * KSS + ud0]);
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vsc[s * VT + uj0]);
          const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] += kr[a] * vr[c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4* cp =
              reinterpret_cast<float4*>(&Cs[(d0 + ud0 + a) * VT + uj0]);
          float4 cv = *cp;
          cv.x = cv.x * decay + acc[a][0];
          cv.y = cv.y * decay + acc[a][1];
          cv.z = cv.z * decay + acc[a][2];
          cv.w = cv.w * decay + acc[a][3];
          *cp = cv;
        }
      }
      if (tid < DT) {
        float acc = 0.f;
        for (int s = 0; s < L; ++s) acc += KT[tid * QS + s] * sc[s];
        ns[d0 + tid] = ns[d0 + tid] * decay + acc;
      }
    }

    // ---- outputs of the chunk ----
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c)   // W * (q k^T), zero where masked
        Wm[(kt0 + a) * (CH + 4) + ks0 + c] *= aqk[a][c];
    if (tid < CH) qn[tid] = aqn;
    __syncthreads();
    if (tid < L) {
      const int t = tid;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += Wm[t * (CH + 4) + s];
      acc += sce[t] * qn[t];
      den[t] = fmaxf(fabsf(acc), expf(-mo[t]));
    }
    __syncthreads();
    if (c_on) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ct0 + a;
        if (t < L) {
          float n0 = 0.f, n1 = 0.f;
          for (int s = 0; s <= t; ++s) {
            const float w = Wm[t * (CH + 4) + s];
            const float2 vv =
                *reinterpret_cast<const float2*>(&Vs[s * VT + cj0]);
            n0 += w * vv.x;
            n1 += w * vv.y;
          }
          n0 += sce[t] * aqc[a][0];
          n1 += sce[t] * aqc[a][1];
          float* yp =
              &p.y[(((long long)b * p.S + c0 + t) * p.H + h) * hd + v0 + cj0];
          yp[0] = n0 / den[t];
          yp[1] = n1 / den[t];
        }
      }
    }
    __syncthreads();   // everyone has read this chunk's gates and m
    if (tid == 0) {
      scal[0] = m_new;
      scal[1] += tot;
    }
    __syncthreads();
  }

  // ---- final state ----
  float* C = p.C + ((long long)b * p.H + h) * hd * hd;
  for (int idx = tid; idx < hd * VT; idx += NT) {
    const int d = idx / VT, j = idx % VT;
    C[(long long)d * hd + v0 + j] = Cs[idx];
  }
  if (vti == 0) {
    float* n = p.n + ((long long)b * p.H + h) * hd;
    for (int d = tid; d < hd; d += NT) n[d] = ns[d];
    if (tid == 0) {
      p.m[b * p.H + h] = scal[0];
      p.loga[b * p.H + h] = scal[1];
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  // Allow the largest block (hd 512) once, at the first launch, so that no
  // later launch (one inside a CUDA-graph capture, say) makes the call.
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(MAX_HD, TMAX) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int bytes = smem_floats(p.hd, p.vt) * (int)sizeof(float);
  const long long blocks = (long long)p.B * p.H * (p.hd / p.vt);
  mlstm_fwd<T><<<(unsigned)blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Widest value tile the kernel uses for head dim hd, or 0 if hd is refused.
// The tile divides the block's 256 threads: 16, 32 or 64 columns.
int value_tile(int hd) {
  if (hd == 16 || hd == 32) return hd;
  if (hd <= 0 || hd > MAX_HD || hd % TMAX) return 0;
  return TMAX;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v alike).  Returns 0 on success,
// a CUDA error code, -1 for a head dim, -2 for a dtype, -3 for shapes.
int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const float* g, const float* i, float* y, float* C,
                    float* n, float* m, float* loga, int dtype, int B, int S,
                    int H, int hd, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long g_sb, long long g_ss,
                    long long g_sh, long long i_sb, long long i_ss,
                    long long i_sh, float scale, void* stream) {
  const int vt = value_tile(hd);
  if (vt == 0) return -1;
  if (B < 1 || S < 1 || H < 1) return -3;
  if ((long long)B * H * (hd / vt) > 0x7fffffffLL) return -3;
  Params p{q, k, v, g, i, y, C, n, m, loga, B, S, H, hd, vt,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           g_sb, g_ss, g_sh, i_sb, i_ss, i_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return -2;
}

}  // extern "C"
