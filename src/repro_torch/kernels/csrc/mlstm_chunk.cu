// Chunkwise stabilized mLSTM (matrix-memory linear attention with exponential
// gates) for Hopper (sm_90a), forward, with the final recurrence state.
//
// Replaces the Pallas TPU kernel `mlstm_chunk` in
// src/repro/kernels/mlstm_chunk.py (entry :87, pallas_call :103, body
// `_kernel` :26).  It computes what that kernel computes, the normalized
// recurrence h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t)) with scale
// 1/sqrt(hd), in the chunkwise form: per chunk the cumulative log decay lg,
// the log-gate matrix D[t,s] = lg_t - lg_s + i_s (s <= t), the stabilizer
// m_out = max(lg + m_enter, max_s D), W = exp(D - m_out) and
// y = (W*(q k^T)) v + exp(lg + m_enter - m_out) q C_enter, over the
// normalizer max(|row sum of W*(q k^T) + ... q n_enter|, exp(-m_out)).  It
// also returns the final state (loga, m, C, n), which the Pallas kernel
// drops: prefill hands it to decode as the cache.  Any S (the last chunk
// may be short) and any B*H; hd 16, 32, or a multiple of 64 up to 512.
// It may start from a given state instead of the zero one (under sequence
// parallelism a rank's columns start from the combine of the ranks' before
// it, src/repro/models/ssm.py:167-181) and may return the final state alone
// (a rank's own summary, which those prefixes are made of).
//
// The CUDA-core path also computes the other form of the JAX package's
// `ssm.linear_recurrence` (src/repro/models/ssm.py:141), the one Hymba's
// Mamba heads call (src/repro/models/blocks.py:178): `normalize` off, any
// `scale` (Hymba's is 1), and q/k of width dq apart from v's dv.  Off, the
// output is the numerator at the running stabilizer, y_t = (sum_s
// exp(lg_t - lg_s + i_s - m_t) (q_t k_s) v_s + exp(lg_t + m_enter - m_t) q_t
// C_enter) * scale, where m_t = max(lg_t + m_enter, max_{s<=t} lg_t - lg_s +
// i_s) is the state's own running max, the same whatever the chunking.
//
// Inputs: q/k (B,S,H,dq) and v (B,S,H,dv) in f32 or bf16 (dq = dv = hd on
// the wgmma path), any strides with the last dim contiguous (a stride
// of 0 over H reads one q/k for every head: Hymba's broadcast); g/i (B,S,H)
// f32 log forget/input gates, any strides.  Outputs, contiguous f32: y
// (B,S,H,dv), C (B,H,dq,dv), n (B,H,dq), m (B,H), loga (B,H).  Accumulation
// is f32 throughout; m starts at -1e30, as in JAX.
//
// What bounds it on the H100.  At xlstm-350m's serving shape (B=4, S=128,
// H=4, hd=512, bf16) the work, counted in the Pallas kernel's chunks of
// 128, is 1.34 GFLOP: the state product k^T (v*sc) (2*S*hd*hd a head) is
// most of it, q k^T and (W*q k^T) v the rest.  On the tensor cores (989
// TFLOP/s bf16, 495 for products with an f32 operand) that is about 2.6 us;
// the bytes are 27.3 MB (the 16.8 MB final C most of them), 8.2 us at 3.35
// TB/s.  So bytes bound it, and a kernel on the CUDA cores (67 TFLOP/s f32:
// 20 us) cannot come near.
//
// Two paths; the wrapper (mlstm_chunk.py `choose_path`) picks one:
//
// 1. wgmma (`mlstm_state_tc`, then `mlstm_out_tc` as a programmatic
//    dependent launch): bf16 q/k/v with 16-byte aligned pointers and
//    strides, hd a multiple of 64.  Chunks of TC_CH = 128 positions, as the
//    Pallas kernel and the plain version, so the serve shape is one chunk:
//    one state product and one causal decay-masked "attention" with no q C
//    term.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.019
//    ms at the serve shape, against 0.23 for the CUDA-core path that was
//    the only one before (PERF.md).
//    - The stabilizer is known before any product: lg is a block scan of
//      the gates, m_out[t] = max(lg_t + m_enter, lg_t + max_{s<=t}(i_s -
//      lg_s)) a prefix-max scan, so every tile forms W = exp(D - m_out)
//      directly, with no online rescaling.  lg is summed in f64: with
//      gates near log(sigmoid(-10)) |lg| reaches hundreds within a chunk,
//      and an f32 difference lg_t - lg_s would carry ~1e-4 into every
//      exponent, more than 5e-4 allows where the normalizer cancels.
//    - `mlstm_state_tc`: a block owns 64 key rows of one head's C and walks
//      a run of value tiles of VT columns (128, or 64 where hd is not a
//      multiple of 128), each tile in wgmma accumulators through the
//      chunks: C <- decay C + (k*sc)^T v (the prefix combine of the chunk
//      states, carried in registers), then the tile's final C is written
//      once, from the accumulators.  With one chunk the gates and k*sc are
//      made once for the whole run, and the runs are long enough to leave
//      one state block an SM (128 at the serve shape).  v tiles arrive by
//      cp.async into a two-slot ring, the next in flight.  Before each
//      later chunk it writes the entering state for that chunk's outputs (C
//      split into bf16 hi + lo, n, m) to a scratch buffer the wrapper
//      allocates.  Its time is the 16.8 MB of C stores and the latency of
//      the loads and scans before them.
//    - `mlstm_out_tc` runs every (head, chunk, 64 query rows, VT value
//      columns) in parallel: S = q k^T on wgmma over a three-stage cp.async
//      ring of 64-wide q/k tiles (with q C_enter beside it from the same q
//      tile, and q n_enter on the CUDA cores), then W*S in f32, its row
//      sums, and (W*S) v on wgmma with W*S as the register A operand.  It
//      moves few bytes and is a chain of latencies, so it runs beside the
//      state kernel: launched with programmatic stream serialization, it
//      starts once every state block has started, and one block of each
//      fits an SM.  Blocks of a chunk with an entering state wait for the
//      state grid first; the others wait for it before they exit, so the
//      pair completes together.
//    - Precision: q k^T has bf16 operands and is exact with f32
//      accumulation.  The three products with an f32 operand (k*sc, W*S and
//      C_enter) split it into bf16 hi + lo, two bf16 products with about 16
//      mantissa bits, so the path holds atol = rtol = 5e-4 against the
//      sequential oracle; one bf16 pass would not.
// 2. CUDA cores (`mlstm_fwd`): f32 inputs (the parity runs), hd 16 or 32,
//    inputs off 16-byte alignment, and the unnormalized or unequal-width
//    form.  A block owns one (batch, head) and a tile of VT = min(64, dv)
//    value columns, keeps C[:, tile] in shared memory (128 KB at dq 512) and
//    walks chunks of CH = 32 positions in order, the key dimension in tiles
//    of DT = min(64, dq); every block of a head recomputes what reduces over
//    the key dimension.  Products are f32 FMAs from register tiles fed by 8-
//    and 16-byte shared loads.
//    At hymba-1.5b's serving shape (B 4, S 1280, H 25, dq 16, dv 128, bf16,
//    q/k broadcast over the heads) the bytes bound it: ~100 MB (v in, y out
//    in f32: 98 MB of it) is ~30 us at 3.35 TB/s, against ~3.4 GFLOP, 51 us
//    even on the CUDA cores' f32 FMAs.  Its 200 blocks walk 40 chunks each in
//    order, so it is a chain of latencies far from that bound (PERF.md).
//
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).  The
// launches go on the caller's stream; the function returns the CUDA error
// of its launches (0 on success) or a negative code for arguments it
// refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Path 2: CUDA cores.

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
  // the state entering the sequence (all four, or none: the zero state),
  // contiguous f32 (B,H,dq,dv), (B,H,dq), (B,H), (B,H)
  const float* C0;
  const float* n0;
  const float* m0;
  const float* loga0;
  int B, S, H, dq, dv, dt, vt;   // dt: key tile, vt: value tile
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long i_sb, i_ss, i_sh;
  float scale;
  int normalize;   // 0: the numerator at the stabilizer m_out
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Floats of dynamic shared memory a block needs; every array starts 16 B
// aligned (each size is a multiple of 4 floats).
__host__ __device__ inline int smem_floats(int dq, int dt, int vt) {
  return dq * vt              // C[:, tile]
         + dq                 // n
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
  const int dq = p.dq;
  const int VT = p.vt;
  const int DT = p.dt;
  const int KSS = DT + 4;   // row of the position-major k tile
  const int nvt = p.dv / VT;
  int blk = blockIdx.x;
  const int vti = blk % nvt;
  blk /= nvt;
  const int h = blk % p.H;
  const int b = blk / p.H;
  const int v0 = vti * VT;
  const int tid = threadIdx.x;

  float* Cs = smem;                    // [dq][VT]
  float* ns = Cs + dq * VT;            // [dq]
  float* QT = ns + dq;                 // [DT][QS], scaled q
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

  // y null: the final state alone (no output products)
  const bool outs = p.y != nullptr;
  const long long bh = (long long)b * p.H + h;
  if (p.C0 != nullptr) {   // the caller's entering state: C's tile, n, m, loga
    const float* C0 = p.C0 + bh * dq * p.dv + v0;
    for (int idx = tid; idx < dq * VT; idx += NT)
      Cs[idx] = C0[(long long)(idx / VT) * p.dv + idx % VT];
    for (int idx = tid; idx < dq; idx += NT) ns[idx] = p.n0[bh * dq + idx];
  } else {
    for (int idx = tid; idx < dq * VT; idx += NT) Cs[idx] = 0.f;
    for (int idx = tid; idx < dq; idx += NT) ns[idx] = 0.f;
  }
  if (tid == 0) {
    scal[0] = p.C0 != nullptr ? p.m0[bh] : NEG;
    scal[1] = p.C0 != nullptr ? p.loga0[bh] : 0.f;
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
    for (int idx = tid; outs && idx < CH * CH; idx += NT) {
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

    for (int d0 = 0; d0 < dq; d0 += DT) {
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
      if (d0 + DT < dq) fetch(d0 + DT);   // in flight during the products
      // q k^T
      for (int d = 0; outs && d < DT; ++d) {
        const float2 a = *reinterpret_cast<const float2*>(&QT[d * QS + kt0]);
        const float2 c = *reinterpret_cast<const float2*>(&KT[d * QS + ks0]);
        aqk[0][0] += a.x * c.x;
        aqk[0][1] += a.x * c.y;
        aqk[1][0] += a.y * c.x;
        aqk[1][1] += a.y * c.y;
      }
      // q C with the entering C rows of this tile
      if (outs && c_on) {
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
      if (outs && tid < CH)
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
    if (outs) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c)   // W * (q k^T), zero where masked
          Wm[(kt0 + a) * (CH + 4) + ks0 + c] *= aqk[a][c];
      if (tid < CH) qn[tid] = aqn;
      __syncthreads();
      if (tid < L && p.normalize) {
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
            float* yp = &p.y[(((long long)b * p.S + c0 + t) * p.H + h) * p.dv +
                             v0 + cj0];
            if (p.normalize) {
              yp[0] = n0 / den[t];
              yp[1] = n1 / den[t];
            } else {
              yp[0] = n0;
              yp[1] = n1;
            }
          }
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
  float* C = p.C + bh * dq * p.dv;
  for (int idx = tid; idx < dq * VT; idx += NT) {
    const int d = idx / VT, j = idx % VT;
    C[(long long)d * p.dv + v0 + j] = Cs[idx];
  }
  if (vti == 0) {
    float* n = p.n + bh * dq;
    for (int d = tid; d < dq; d += NT) n[d] = ns[d];
    if (tid == 0) {
      p.m[bh] = scal[0];
      p.loga[bh] = scal[1];
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
        smem_floats(MAX_HD, TMAX, TMAX) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int bytes = smem_floats(p.dq, p.dt, p.vt) * (int)sizeof(float);
  const long long blocks = (long long)p.B * p.H * (p.dv / p.vt);
  mlstm_fwd<T><<<(unsigned)blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Widest tile the kernel uses for a width hd of q/k (the key tile) or of v
// (the value tile), or 0 if hd is refused.  The tile divides the block's 256
// threads: 16, 32 or 64 columns.
int value_tile(int hd) {
  if (hd == 16 || hd == 32) return hd;
  if (hd <= 0 || hd > MAX_HD || hd % TMAX) return 0;
  return TMAX;
}

// ---------------------------------------------------------------------------
// Path 1: tensor cores (wgmma), bf16.

constexpr int TC_CH = 128;        // positions per chunk, as the Pallas kernel
constexpr int TC_THREADS = 128;   // one warpgroup a block
constexpr int TC_ROWS = 64;       // query rows of an output block
constexpr int TC_DT = 64;         // key-dim tile: 128 bytes of bf16
constexpr int TC_STAGES = 3;      // the output kernel's cp.async ring
constexpr int TC_BLOCK = TC_CH * 128;   // bytes of 128 rows x 64 bf16

struct TcParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* g;
  const float* i;
  float* y;
  float* C;
  float* n;
  float* m;
  float* loga;
  // the caller's state entering chunk 0, or null (the zero state), as in
  // Params
  const float* C0;
  const float* n0;
  const float* m0;
  const float* loga0;
  // the state entering each chunk that has one, [slot][b*H + h]: C as bf16
  // hi + lo (hd x hd each), n (hd), m; chunk c's slot is c - 1 + inter0
  __nv_bfloat16* e_hi;
  __nv_bfloat16* e_lo;
  float* e_n;
  float* e_m;
  int B, S, H, hd, nc;
  int inter0;    // 1: a state enters chunk 0 (C0 given)
  int outputs;   // 0: the final state alone (the outputs kernel not run)
  int jpb;   // value tiles a state block walks
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long i_sb, i_ss, i_sh;
  float scale;
};

// Inclusive scan over the block's 128 threads in thread order, in f64: a
// sum, or with MAX a running maximum.  Every thread calls it; `red` is 4
// doubles of shared memory.
template <bool MAX>
__device__ __forceinline__ double block_scan(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = MAX ? fmax(x, y) : x + y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  double pre = MAX ? (double)NEG : 0.0;
  for (int w = 0; w < warp; ++w) pre = MAX ? fmax(pre, red[w]) : pre + red[w];
  __syncthreads();
  return MAX ? fmax(pre, x) : pre + x;
}

// (x0, x1) = hi + lo, each a pair of bf16: hi rounds x, lo rounds what is
// left, so hi + lo keeps about 16 of x's 24 mantissa bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The two bf16 of a 32-bit word, as f32: the first (low half), the second.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// acc (64 x VT) += A (64 x 16) B (16 x VT), A and B in shared memory.
template <int VT, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&acc)[VT / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (VT == 64)
    hopper::wgmma_m64n64k16_ss<TA, TB>(acc, a, b, 1);
  else
    hopper::wgmma_m64n128k16_ss<TA, TB>(acc, a, b, 1);
}
// acc (64 x VT) += A (64 x 16, registers) B (16 x VT, MN-major, shared).
template <int VT>
__device__ __forceinline__ void mma_rs(float (&acc)[VT / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (VT == 64)
    hopper::wgmma_m64n64k16_rs<1>(acc, a, b, 1);
  else
    hopper::wgmma_m64n128k16_rs<1>(acc, a, b, 1);
}

// Shared memory of `mlstm_state_tc`, in bytes from a 1024-aligned base:
// (k*sc) hi and lo, each 128 positions x 64 key rows (MN-major A), then two
// v tiles (a ring: the next one in flight), 128 positions x VT in 64-wide
// blocks (MN-major B), then 8 doubles and the floats.
template <int VT>
struct StateShape {
  static constexpr int A = TC_BLOCK;
  static constexpr int V = (VT / 64) * TC_BLOCK;
  static constexpr int VOFF = 2 * A;
  static constexpr int F = VOFF + 2 * V;
  static constexpr int SMEM = 1024 + F + 8 * 8 + (TC_CH + 4 * TC_DT) * 4;
};

// The chunk states, chunk after chunk, for one (batch, head), 64 key rows
// and a run of `p.jpb` value tiles of VT columns: per tile, C <- decay * C
// + (k * sc)^T v over the chunks, with n and m beside it.  The gates and
// k * sc of a chunk are the same for every value tile: with one chunk they
// are made once and serve every tile of the run.
template <int VT>
__global__ void __launch_bounds__(TC_THREADS) mlstm_state_tc(TcParams p) {
  using Sh = StateShape<VT>;
  extern __shared__ uint8_t smem_raw[];
  // wgmma's swizzle reads address bits 7-9: atoms start on 1024 bytes
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  double* red = reinterpret_cast<double*>(sm + Sh::F);   // [8]
  float* sc = reinterpret_cast<float*>(red + 8);         // [TC_CH]
  float* nsum = sc + TC_CH;                              // [4 warps][TC_DT]

  const int hd = p.hd;
  const int n_jt = hd / VT;
  const int n_jg = (n_jt + p.jpb - 1) / p.jpb;
  const int per_bh = (hd / TC_DT) * n_jg;
  const int bh = blockIdx.x / per_bh;
  const int dg = blockIdx.x % per_bh;
  const int d0 = (dg / n_jg) * TC_DT;
  const int jg = dg % n_jg;
  const int jt0 = jg * p.jpb;
  const int jt1 = min(n_jt, jt0 + p.jpb);
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const long long BH = (long long)p.B * p.H;
  const bool writes_n = jg == 0;              // n and n_enter of the rows
  const bool writes_m = writes_n && d0 == 0;  // m, loga and m_enter

  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh + d0;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* gp = p.g + b * p.g_sb + h * p.g_sh;
  const float* ip = p.i + b * p.i_sb + h * p.i_sh;
  const int kc = tid & 7;     // this thread's 16-byte chunk of a k row
  // the outputs kernel may start beside this grid (it waits for it where it
  // reads what this grid writes)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // the v tile of (value tile jt, chunk c) into ring slot `slot`; rows
  // past the chunk's end are zeros
  auto load_v = [&](int jt, int c, int slot) {
    constexpr int VCH = VT / 8;   // 16-byte chunks of a v row
    const int c0 = c * TC_CH;
    const int L = min(TC_CH, p.S - c0);
#pragma unroll
    for (int r = 0; r < TC_CH * VCH / TC_THREADS; ++r) {
      const int idx = tid + r * TC_THREADS;
      const int s = idx / VCH, cc = idx % VCH;
      const bool ok = s < L;
      const uint32_t dst = base + Sh::VOFF + slot * Sh::V +
                           (cc >> 3) * TC_BLOCK + hopper::swizzle128(s, cc & 7);
      hopper::cp_async16(dst, vb + (long long)(ok ? c0 + s : 0) * p.v_ss +
                                  jt * VT + cc * 8, ok ? 16 : 0);
    }
  };
  load_v(jt0, 0, 0);
  hopper::cp_async_commit();

  float acc[VT / 2];
  float m_new = NEG, decay = 0.f;
  double tot = 0.0;
  int step = 0;
  for (int jt = jt0; jt < jt1; ++jt) {
#pragma unroll
    for (int x = 0; x < VT / 2; ++x) acc[x] = 0.f;
    float m_prev = NEG;
    double loga = 0.0;
    float n_reg = 0.f;        // n[d0 + tid] for tid < 64, first tile only
    if (p.inter0) {   // the caller's entering state: this tile of C, n, m
      const float* cin =
          p.C0 + (long long)bh * hd * hd + (long long)d0 * hd + jt * VT;
#pragma unroll
      for (int jj = 0; jj < VT / 8; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = warp * 16 + (lane >> 2) + 8 * h2;
          const float* r = cin + (long long)row * hd + 8 * jj + 2 * quad;
          acc[4 * jj + 2 * h2] = r[0];
          acc[4 * jj + 2 * h2 + 1] = r[1];
        }
      m_prev = p.m0[bh];
      loga = p.loga0[bh];
      if (tid < TC_DT) n_reg = p.n0[(long long)bh * hd + d0 + tid];
    }
    const bool first = jt == jt0;
    for (int c = 0; c < p.nc; ++c, ++step) {
      const int c0 = c * TC_CH;
      const int L = min(TC_CH, p.S - c0);
      {   // the next step's v tile, in flight during this one
        const int nx_c = c + 1 < p.nc ? c + 1 : 0;
        const int nx_j = c + 1 < p.nc ? jt : jt + 1;
        if (nx_j < jt1) load_v(nx_j, nx_c, (step + 1) & 1);
        hopper::cp_async_commit();
      }
      if (p.nc > 1 || first) {
        // ---- k chunks into registers first, in flight during the scans
        constexpr int KR = TC_CH * 8 / TC_THREADS;   // k rows a thread loads
        uint4 kw[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          const int s = (tid >> 3) + r * (TC_THREADS / 8);
          kw[r] = make_uint4(0u, 0u, 0u, 0u);
          if (s < L)
            kw[r] = *reinterpret_cast<const uint4*>(
                kb + (long long)(c0 + s) * p.k_ss + kc * 8);
        }
        // ---- gates: cumulative log decay (f64: a difference of two sums
        // of up to 128 log gates keeps its precision), m, weights ----
        float gt = 0.f, it = 0.f;
        if (tid < L) {
          gt = gp[(long long)(c0 + tid) * p.g_ss];
          it = ip[(long long)(c0 + tid) * p.i_ss];
        }
        const double lg = block_scan<false>(gt, red);
        if (tid == L - 1) red[4] = lg;
        __syncthreads();
        tot = red[4];
        // the log weight carried to the chunk's end
        const float w = tid < L ? (float)(tot - lg) + it : NEG;
        const double w_max = block_scan<true>(w, red);
        if (tid == TC_THREADS - 1) red[5] = w_max;
        __syncthreads();
        const double m_carry = (double)m_prev + tot;
        m_new = (float)fmax(m_carry, red[5]);
        decay = expf((float)(m_carry - m_new));
        sc[tid] = tid < L ? expf(w - m_new) : 0.f;
        __syncthreads();
        // ---- k * sc in f32, stored as bf16 hi + lo; n's chunk sum ----
        float nacc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) nacc[e] = 0.f;
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          const int s = (tid >> 3) + r * (TC_THREADS / 8);
          const float f = sc[s];
          const uint32_t wd[4] = {kw[r].x, kw[r].y, kw[r].z, kw[r].w};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = bf_lo(wd[e]) * f;
            const float x1 = bf_hi(wd[e]) * f;
            nacc[2 * e] += x0;
            nacc[2 * e + 1] += x1;
            split_bf16(x0, x1, hi[e], lo[e]);
          }
          const uint32_t off = hopper::swizzle128(s, kc);
          *reinterpret_cast<uint4*>(sm + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(sm + Sh::A + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        if (first) {   // the 16 threads of each k chunk, then the 4 warps
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            nacc[e] += __shfl_xor_sync(0xffffffffu, nacc[e], 8);
            nacc[e] += __shfl_xor_sync(0xffffffffu, nacc[e], 16);
          }
          if (lane < 8)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              nsum[warp * TC_DT + kc * 8 + e] = nacc[e];
        }
      }
      hopper::cp_async_wait<1>();   // this step's v tile
      hopper::fence_proxy_async();
      __syncthreads();

      // ---- the state entering this chunk, for its outputs ----
      if (p.outputs && (c > 0 || p.inter0)) {
        const long long e = (long long)(c - 1 + p.inter0) * BH + bh;
        __nv_bfloat16* eh =
            p.e_hi + e * hd * hd + (long long)d0 * hd + jt * VT;
        __nv_bfloat16* el =
            p.e_lo + e * hd * hd + (long long)d0 * hd + jt * VT;
#pragma unroll
        for (int jj = 0; jj < VT / 8; ++jj)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int row = warp * 16 + (lane >> 2) + 8 * h2;
            const long long off = (long long)row * hd + 8 * jj + 2 * quad;
            uint32_t hi, lo;
            split_bf16(acc[4 * jj + 2 * h2], acc[4 * jj + 2 * h2 + 1], hi,
                       lo);
            *reinterpret_cast<uint32_t*>(eh + off) = hi;
            *reinterpret_cast<uint32_t*>(el + off) = lo;
          }
        if (first && writes_n && tid < TC_DT)
          p.e_n[e * hd + d0 + tid] = n_reg;
        if (first && writes_m && tid == 0) p.e_m[e] = m_prev;
      }

      // ---- C <- decay C + (k sc)^T v: the f32 product as hi and lo
      // (rows past the chunk's end are zeros) ----
#pragma unroll
      for (int x = 0; x < VT / 2; ++x) acc[x] *= decay;
      const uint32_t vs = base + Sh::VOFF + (step & 1) * Sh::V;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_CH / 16; ++kk) {
        const uint64_t dv = hopper::make_desc(vs + kk * 2048, TC_BLOCK, 1024);
        mma_ss<VT, 1, 1>(acc, hopper::make_desc(base + kk * 2048, TC_BLOCK,
                                                1024), dv);
        mma_ss<VT, 1, 1>(acc, hopper::make_desc(base + Sh::A + kk * 2048,
                                                TC_BLOCK, 1024), dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
      if (first && tid < TC_DT)
        n_reg = n_reg * decay + ((nsum[tid] + nsum[TC_DT + tid]) +
                                 (nsum[2 * TC_DT + tid] +
                                  nsum[3 * TC_DT + tid]));
      m_prev = m_new;
      loga += tot;
      __syncthreads();   // the next step refills the tiles
    }

    // ---- this value tile's final C, straight from the accumulators ----
    float* Cb = p.C + (long long)bh * hd * hd + (long long)d0 * hd + jt * VT;
#pragma unroll
    for (int jj = 0; jj < VT / 8; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = warp * 16 + (lane >> 2) + 8 * h2;
        *reinterpret_cast<float2*>(Cb + (long long)row * hd + 8 * jj +
                                   2 * quad) =
            make_float2(acc[4 * jj + 2 * h2], acc[4 * jj + 2 * h2 + 1]);
      }
    if (first && writes_n && tid < TC_DT)
      p.n[(long long)bh * hd + d0 + tid] = n_reg;
    if (first && writes_m && tid == 0) {
      p.m[bh] = m_prev;
      p.loga[bh] = (float)loga;
    }
  }
}

// Shared memory of `mlstm_out_tc`, in bytes from a 1024-aligned base: the v
// tile (128 positions x VT, MN-major B), then TC_STAGES stages of q (64
// rows x 64 key dims), k (128 positions x 64) and, when the call has more
// than one chunk, C_enter hi and lo (64 key dims x VT, MN-major B); then
// doubles and floats.
template <int VT>
struct OutShape {
  static constexpr int V = (VT / 64) * TC_BLOCK;
  static constexpr int Q = TC_ROWS * 128;
  static constexpr int K = TC_BLOCK;
  static constexpr int EB = TC_DT * 128;   // a 64-wide block of C_enter
  static constexpr int E = (VT / 64) * EB;
  __host__ __device__ static constexpr int stage(bool multi) {
    return Q + K + (multi ? 2 * E : 0);
  }
  __host__ __device__ static constexpr int floats(bool multi) {
    return V + TC_STAGES * stage(multi);
  }
  __host__ __device__ static constexpr int smem(bool multi) {
    return 1024 + floats(multi) + 8 * 8 + TC_CH * 8 +
           (TC_CH + 3 * TC_ROWS) * 4;
  }
};

// The outputs of 64 query rows x VT value columns of one chunk of one
// (batch, head): rows t0.. of chunk c, value columns j0...  INTER: a state
// enters the chunk (c > 0, or the caller's at chunk 0), so q C_enter and q
// n_enter join the sums.  The two forms are compiled apart, so that each
// runs its wgmmas with no branch between them.
template <int VT, bool INTER>
__device__ __forceinline__ void out_block(const TcParams& p, uint8_t* sm,
                                          uint32_t base, int bh, int c,
                                          int t0, int j0) {
  using Sh = OutShape<VT>;
  const bool multi = p.nc > 1 || p.inter0;   // some chunk has a state
  const int stage_bytes = Sh::stage(multi);
  // [TC_CH] the cumulative log decay as f32 hi + lo (its f64 value to
  // about 48 bits: lg_t - lg_s = (hi_t - hi_s) + (lo_t - lo_s) in f32 keeps
  // the difference to an f32 rounding)
  double* red = reinterpret_cast<double*>(sm + Sh::floats(multi));   // [8]
  float2* lgs = reinterpret_cast<float2*>(red + 8);
  float* igs = reinterpret_cast<float*>(lgs + TC_CH);   // [TC_CH]
  float* mo = igs + TC_CH;     // [TC_ROWS] m_out
  float* sce = mo + TC_ROWS;   // [TC_ROWS] exp(lg + m_enter - m_out)
  float* qn = sce + TC_ROWS;   // [TC_ROWS] q . n_enter * scale

  const int hd = p.hd;
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = c * TC_CH;
  const int L = min(TC_CH, p.S - c0);
  const int nk = min(L, t0 + TC_ROWS);   // keys the rows see (causal)
  const long long e_idx =   // INTER
      (long long)(c - 1 + p.inter0) * p.B * p.H + bh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;

  const __nv_bfloat16* qb =
      p.q + b * p.q_sb + h * p.q_sh + (long long)(c0 + t0) * p.q_ss;
  const __nv_bfloat16* kb =
      p.k + b * p.k_sb + h * p.k_sh + (long long)c0 * p.k_ss;
  const __nv_bfloat16* vb =
      p.v + b * p.v_sb + h * p.v_sh + (long long)c0 * p.v_ss + j0;
  const int n_d = hd / TC_DT;
  // launched beside the state kernel: wait for it before reading the
  // entering state it writes
  if constexpr (INTER) asm volatile("griddepcontrol.wait;" ::: "memory");

  // ---- loads first: the gates, then the ring's first tiles of q, k (and
  // C_enter), 64 key dims each, in flight during the gate scans; the v tile
  // (rows past the keys the block sees are zeros) rides with the last ----
  float gt = 0.f, it = NEG;
  if (tid < L) {
    gt = p.g[b * p.g_sb + h * p.g_sh + (long long)(c0 + tid) * p.g_ss];
    it = p.i[b * p.i_sb + h * p.i_sh + (long long)(c0 + tid) * p.i_ss];
  }
  constexpr int VCH = VT / 8;
  auto load_v = [&]() {
#pragma unroll
    for (int r = 0; r < TC_CH * VCH / TC_THREADS; ++r) {
      const int idx = tid + r * TC_THREADS;
      const int s = idx / VCH, cc = idx % VCH;
      const bool ok = s < nk;
      hopper::cp_async16(
          base + (cc >> 3) * TC_BLOCK + hopper::swizzle128(s, cc & 7),
          vb + (long long)(ok ? s : 0) * p.v_ss + cc * 8, ok ? 16 : 0);
    }
  };
  auto load_tile = [&](int dt, int st) {
    const uint32_t sb = base + Sh::V + st * stage_bytes;
    const int dd = dt * TC_DT;
#pragma unroll
    for (int r = 0; r < TC_ROWS * 8 / TC_THREADS; ++r) {
      const int idx = tid + r * TC_THREADS;
      const int row = idx >> 3, cc = idx & 7;
      const bool ok = t0 + row < L;
      hopper::cp_async16(sb + hopper::swizzle128(row, cc),
                         qb + (long long)(ok ? row : 0) * p.q_ss + dd + cc * 8,
                         ok ? 16 : 0);
    }
#pragma unroll
    for (int r = 0; r < TC_CH * 8 / TC_THREADS; ++r) {
      const int idx = tid + r * TC_THREADS;
      const int s = idx >> 3, cc = idx & 7;
      const bool ok = s < nk;
      hopper::cp_async16(sb + Sh::Q + hopper::swizzle128(s, cc),
                         kb + (long long)(ok ? s : 0) * p.k_ss + dd + cc * 8,
                         ok ? 16 : 0);
    }
    if constexpr (INTER) {
      const long long src0 = e_idx * hd * hd + (long long)dd * hd + j0;
#pragma unroll
      for (int r = 0; r < TC_DT * VCH / TC_THREADS; ++r) {
        const int idx = tid + r * TC_THREADS;
        const int row = idx / VCH, cc = idx % VCH;
        const uint32_t dst = sb + Sh::Q + Sh::K + (cc >> 3) * Sh::EB +
                             hopper::swizzle128(row, cc & 7);
        const long long src = src0 + (long long)row * hd + cc * 8;
        hopper::cp_async16(dst, p.e_hi + src, 16);
        hopper::cp_async16(dst + Sh::E, p.e_lo + src, 16);
      }
    }
    if (dt == n_d - 1) load_v();
  };
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < n_d) load_tile(st, st);
    hopper::cp_async_commit();
  }

  // ---- gates: lg by a block scan in f64, each row's m_out by a prefix
  // max, m_out[t] = max(lg_t + m_enter, lg_t + max_{s<=t}(i_s - lg_s)) ----
  const double lg = block_scan<false>(gt, red);
  const double pm = block_scan<true>(tid < L ? it - lg : (double)NEG, red);
  {
    const float hi = (float)lg;
    lgs[tid] = make_float2(hi, (float)(lg - hi));
  }
  igs[tid] = it;
  {
    const int r = tid - t0;
    if (r >= 0 && r < TC_ROWS) {
      const double lge = lg + (INTER ? p.e_m[e_idx] : NEG);
      const float mout = (float)fmax(lge, lg + pm);
      const bool live = tid < L;
      mo[r] = live ? mout : 0.f;
      sce[r] = live ? expf((float)(lge - mout)) : 0.f;
      qn[r] = 0.f;
    }
  }

  float s_acc[TC_CH / 2];        // S = q k^T: 64 rows x 128 keys
  float acc[VT / 2];             // 64 rows x VT values
#pragma unroll
  for (int x = 0; x < TC_CH / 2; ++x) s_acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < VT / 2; ++x) acc[x] = 0.f;
  float qacc = 0.f;
  const float* ne = INTER ? p.e_n + e_idx * hd : nullptr;   // n_enter

  for (int dt = 0; dt < n_d; ++dt) {
    hopper::cp_async_wait<TC_STAGES - 2>();
    hopper::fence_proxy_async();
    __syncthreads();   // tile dt is in; tile dt-1's stage is free
    {
      const int nx = dt + TC_STAGES - 1;
      if (nx < n_d) load_tile(nx, nx % TC_STAGES);
      hopper::cp_async_commit();
    }
    const uint32_t sb = base + Sh::V + (dt % TC_STAGES) * stage_bytes;
    hopper::fence_regs(s_acc);
    if constexpr (INTER) hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_DT / 16; ++kk) {
      const uint64_t dq = hopper::make_desc(sb + kk * 32, 16, 1024);
      hopper::wgmma_m64n128k16_ss<0, 0>(
          s_acc, dq, hopper::make_desc(sb + Sh::Q + kk * 32, 16, 1024), 1);
      if constexpr (INTER) {   // q C_enter, C_enter as hi and lo
        const uint32_t eb = sb + Sh::Q + Sh::K + kk * 2048;
        mma_ss<VT, 0, 1>(acc, dq, hopper::make_desc(eb, Sh::EB, 1024));
        mma_ss<VT, 0, 1>(acc, dq,
                         hopper::make_desc(eb + Sh::E, Sh::EB, 1024));
      }
    }
    hopper::wgmma_commit();
    if constexpr (INTER) {   // q . n_enter on the CUDA cores, beside
      const int row = tid >> 1;
      const uint8_t* qs = sm + (sb - base);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = (tid & 1) * 4 + u;
        const uint4 w4 =
            *reinterpret_cast<const uint4*>(qs + hopper::swizzle128(row, cc));
        const float4 n0 =
            *reinterpret_cast<const float4*>(ne + dt * TC_DT + cc * 8);
        const float4 n1 =
            *reinterpret_cast<const float4*>(ne + dt * TC_DT + cc * 8 + 4);
        qacc += bf_lo(w4.x) * n0.x + bf_hi(w4.x) * n0.y +
                bf_lo(w4.y) * n0.z + bf_hi(w4.y) * n0.w +
                bf_lo(w4.z) * n1.x + bf_hi(w4.z) * n1.y +
                bf_lo(w4.w) * n1.z + bf_hi(w4.w) * n1.w;
      }
    }
    hopper::wgmma_wait_all();
    hopper::fence_regs(s_acc);
    if constexpr (INTER) hopper::fence_regs(acc);
  }
  if constexpr (INTER) {
    qacc += __shfl_xor_sync(0xffffffffu, qacc, 1);
    if ((tid & 1) == 0) qn[tid >> 1] = qacc * p.scale;
    __syncthreads();
  }   // (the loop's barriers publish the gates' arrays)

  // ---- W * S in f32, its row sums; s_acc[4j + 2h + c] is row ra + 8h,
  // key 8j + 2 quad + c.  W = exp(D - m_out), D = lg_t - lg_s + i_s;
  // masked pairs (s > t, or rows past the chunk) are 0 ----
  const int ra = warp * 16 + (lane >> 2);
  float den[2] = {0.f, 0.f};
  float2 lt[2];
  float mrow[2];
  int trow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    trow[h2] = t0 + ra + 8 * h2;
    lt[h2] = lgs[trow[h2]];
    mrow[h2] = mo[ra + 8 * h2];
    if (trow[h2] >= L) trow[h2] = -1;   // a dead row sees no key
  }
#pragma unroll
  for (int jj = 0; jj < TC_CH / 8; ++jj)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int s = 8 * jj + 2 * quad + cc;
      const float2 ls = lgs[s];
      const float is = igs[s];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int x = 4 * jj + 2 * h2 + cc;
        const float d = ((lt[h2].x - ls.x) + (lt[h2].y - ls.y)) + is;
        const float ws = __expf(d - mrow[h2]) * (s_acc[x] * p.scale);
        s_acc[x] = s <= trow[h2] ? ws : 0.f;
        den[h2] += s_acc[x];
      }
    }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    den[h2] += __shfl_xor_sync(0xffffffffu, den[h2], 1);
    den[h2] += __shfl_xor_sync(0xffffffffu, den[h2], 2);
  }
  if constexpr (INTER) {   // the entering state's share, at this row's m_out
    const float f0 = sce[ra] * p.scale, f1 = sce[ra + 8] * p.scale;
#pragma unroll
    for (int jj = 0; jj < VT / 8; ++jj) {
      acc[4 * jj] *= f0;
      acc[4 * jj + 1] *= f0;
      acc[4 * jj + 2] *= f1;
      acc[4 * jj + 3] *= f1;
    }
    den[0] += sce[ra] * qn[ra];
    den[1] += sce[ra + 8] * qn[ra + 8];
  }

  // ---- acc += (W*S) v: W*S as hi and lo register A operands, 16 keys a
  // step (the S fragment of keys 16kk.. is the A fragment of step kk; keys
  // past nk are zeros in both) ----
  uint32_t ph[TC_CH / 16][4], pl[TC_CH / 16][4];
#pragma unroll
  for (int kk = 0; kk < TC_CH / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split_bf16(s_acc[8 * kk + 2 * x], s_acc[8 * kk + 2 * x + 1], ph[kk][x],
                 pl[kk][x]);
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TC_CH / 16; ++kk) {
    const uint64_t dv = hopper::make_desc(base + kk * 2048, TC_BLOCK, 1024);
    mma_rs<VT>(acc, ph[kk], dv);
    mma_rs<VT>(acc, pl[kk], dv);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::fence_regs(acc);

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int t = trow[h2];
    if (t < 0) continue;
    const float inv = 1.f / fmaxf(fabsf(den[h2]), expf(-mrow[h2]));
    float* yrow = p.y + (((long long)b * p.S + c0 + t) * p.H + h) * hd + j0;
#pragma unroll
    for (int jj = 0; jj < VT / 8; ++jj)
      *reinterpret_cast<float2*>(yrow + 8 * jj + 2 * quad) = make_float2(
          acc[4 * jj + 2 * h2] * inv, acc[4 * jj + 2 * h2 + 1] * inv);
  }
  // no block ends before the state kernel has: the pair completes together
  if constexpr (!INTER) asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Every (batch, head, chunk, 64 query rows, VT value columns) in parallel.
template <int VT>
__global__ void __launch_bounds__(TC_THREADS) mlstm_out_tc(TcParams p) {
  extern __shared__ uint8_t smem_raw[];
  // wgmma's swizzle reads address bits 7-9: atoms start on 1024 bytes
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const int n_jt = p.hd / VT;
  int blk = blockIdx.x;
  const int jt = blk % n_jt;
  blk /= n_jt;
  const int rt = blk % (TC_CH / TC_ROWS);
  blk /= TC_CH / TC_ROWS;
  const int c = blk % p.nc;
  const int bh = blk / p.nc;
  const int t0 = rt * TC_ROWS;
  if (t0 >= min(TC_CH, p.S - c * TC_CH)) return;   // a short last chunk
  if (c > 0 || p.inter0)
    out_block<VT, true>(p, sm, base, bh, c, t0, jt * VT);
  else
    out_block<VT, false>(p, sm, base, bh, c, t0, jt * VT);
}

template <int VT>
int launch_tc(TcParams p, cudaStream_t stream) {
  // Allow the largest blocks once, at the first launch, so that no later
  // launch (one inside a CUDA-graph capture, say) makes the call.
  static bool allowed = false;
  static int n_sm = 132;
  if (!allowed) {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_state_tc<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StateShape<VT>::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(mlstm_out_tc<VT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               OutShape<VT>::smem(true));
    if (err != cudaSuccess) return (int)err;
    // the whole carveout as shared memory, so that an SM running a state
    // block has room for an outputs block beside it
    for (const void* f : {(const void*)mlstm_state_tc<VT>,
                          (const void*)mlstm_out_tc<VT>}) {
      err = cudaFuncSetAttribute(f,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
    }
    allowed = true;
  }
  const long long bh = (long long)p.B * p.H;
  // State blocks: one per (batch, head, 64 key rows), each walking a run of
  // value tiles.  With one chunk and no state entering it the outputs
  // kernel runs beside the state kernel (it needs nothing from it), so the
  // runs are split until there is one state block an SM, leaving room on
  // each SM for an outputs block; when some chunk has an entering state
  // the outputs wait for the states, and the runs are split until two
  // state blocks an SM are in flight.
  const long long rows = bh * (p.hd / TC_DT);
  const int n_jt = p.hd / VT;
  const bool inter = p.nc > 1 || p.inter0;   // some chunk waits for states
  const long long per_sm = inter ? 2 : 1;
  const long long want = per_sm * n_sm / rows;
  const int runs = (int)(want < 1 ? 1 : want > n_jt ? n_jt : want);
  p.jpb = (n_jt + runs - 1) / runs;
  const long long n_state = rows * ((n_jt + p.jpb - 1) / p.jpb);
  const long long n_out = bh * p.nc * (TC_CH / TC_ROWS) * (p.hd / VT);
  if (n_state > INT_MAX || n_out > INT_MAX) return -3;
  mlstm_state_tc<VT><<<(unsigned)n_state, TC_THREADS, StateShape<VT>::SMEM,
                       stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !p.outputs) return (int)err;
  // a programmatic dependent launch: it may start once every state block
  // has started (griddepcontrol in the kernels orders what must wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_out);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = OutShape<VT>::smem(inter);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlstm_out_tc<VT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (s0 * 2) % 16 == 0 &&
         (s1 * 2) % 16 == 0 && (s2 * 2) % 16 == 0;
}

}  // namespace

extern "C" {

// path: 0 = CUDA cores (f32 or bf16), 1 = wgmma (bf16, 16-byte aligned, dq
// = dv a multiple of 64, normalized).  dtype: 0 = float32, 1 = bfloat16 (q,
// k, v alike).  dq: width of q and k, dv: of v.  normalize: 1 divides by the
// normalizer, 0 returns the numerator at the stabilizer.  C0, n0, m0, loga0:
// the state entering the sequence, contiguous f32 (B,H,dq,dv), (B,H,dq),
// (B,H), (B,H), all four or none (null: the zero state, as before they
// existed); the final state returned is then the combine of that state with
// the sequence's.  y null: the final state alone (the CUDA-core path skips
// the output products, the wgmma path launches its state kernel only).
// `scratch` holds the wgmma path's entering states when it makes outputs and
// some chunk has one (f32 words: (ceil(S/128) - 1 + (C0 given)) * B * H *
// (hd*hd + hd + 1), see scratch_floats in mlstm_chunk.py).  Returns 0 on
// success, a CUDA error code, -1 for a head dim, -2 for a dtype, -3 for
// shapes, alignment, a partial entering state or a missing scratch, -4 for
// a path, -5 for a form (unnormalized or dq != dv) the wgmma path does not
// take.
int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const float* g, const float* i, float* y, float* C,
                    float* n, float* m, float* loga, const float* C0,
                    const float* n0, const float* m0, const float* loga0,
                    int dtype, int B, int S, int H, int dq, int dv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long g_sb, long long g_ss, long long g_sh,
                    long long i_sb, long long i_ss, long long i_sh,
                    float scale, int normalize, int path, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return -3;
  const bool init = C0 != nullptr;
  if ((n0 != nullptr) != init || (m0 != nullptr) != init ||
      (loga0 != nullptr) != init)
    return -3;
  if (path == 1) {
    if (dq != dv || !normalize) return -5;
    const int hd = dq;
    if (hd < TC_DT || hd > MAX_HD || hd % TC_DT) return -1;
    if (dtype != 1) return -2;
    if (!aligned16(q, q_sb, q_ss, q_sh) || !aligned16(k, k_sb, k_ss, k_sh) ||
        !aligned16(v, v_sb, v_ss, v_sh))
      return -3;
    const int nc = (S + TC_CH - 1) / TC_CH;
    const long long e = y != nullptr ? (long long)(nc - 1 + init) * B * H : 0;
    if (e > 0 && (scratch == nullptr ||
                  reinterpret_cast<uintptr_t>(scratch) % 16 != 0))
      return -3;
    float* sf = static_cast<float*>(scratch);
    __nv_bfloat16* e_hi = e > 0 ? static_cast<__nv_bfloat16*>(scratch)
                                : nullptr;
    TcParams tp{static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v), g, i, y, C, n, m, loga,
                C0, n0, m0, loga0,
                e_hi, e > 0 ? e_hi + e * hd * hd : nullptr,
                e > 0 ? sf + e * hd * hd : nullptr,
                e > 0 ? sf + e * hd * (hd + 1) : nullptr,
                B, S, H, hd, nc, init, y != nullptr, 1,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                g_sb, g_ss, g_sh, i_sb, i_ss, i_sh, scale};
    return hd % 128 == 0 ? launch_tc<128>(tp, st) : launch_tc<64>(tp, st);
  }
  if (path != 0) return -4;
  const int dt = value_tile(dq), vt = value_tile(dv);
  if (dt == 0 || vt == 0) return -1;
  if ((long long)B * H * (dv / vt) > 0x7fffffffLL) return -3;
  Params p{q, k, v, g, i, y, C, n, m, loga, C0, n0, m0, loga0,
           B, S, H, dq, dv, dt, vt,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           g_sb, g_ss, g_sh, i_sb, i_ss, i_sh, scale, normalize != 0};
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return -2;
}

}  // extern "C"
