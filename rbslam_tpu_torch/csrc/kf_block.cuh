// The dense Kalman update of one particle's covariance (K5, in
// kf_update.cu) and its products without the gather and the innovation
// algebra (the probe K11, in probes.cu): one device code for both, chosen
// by kUpdate. Per particle b, with P its covariance (K5: P_all[ai[b]], the
// ancestor's; K11: P[b]):
//   CP = Cr P (f32 sums)
//   K5:  Cr = round(C); S = CP C^T + R; (S^-1, log|S|, bad) by the closed-form
//        ny <= 3 Cholesky with the Gershgorin repair;
//        logw = -1/2 e^T S^-1 e - 1/2 log|S| - ny/2 log 2pi;
//        K3 = S^-1 CP; xl' = xl + e^T K3; P' = P - round(round(CP)^T round(K3))
//   K11: Cr = C; P' = round(P - CP^T (gain CP)), gain = 0.7
// where round() is the storage dtype's rounding.
//
// Bound: the bytes, one read of P and one write of P' (the products are
// rank ny <= 3, 6 FMA an element, hidden by the CUDA cores). P' depends on
// all of C P, so a particle's writes wait for all its reads: the card stays
// busy only with several particles in flight on each SM. Forms, by the
// width of P (block_gather_plan; the wrapper mirrors it):
//  - resident (P up to 64 KB: nl=128 at f32 or bf16): one block of 256
//    threads per particle, four blocks an SM at bf16, two at f32, so one
//    block's algebra overlaps its neighbours' copies. Thread 0 brings P into
//    shared memory by bulk copies in stages of about 8 KB, each on its own
//    mbarrier; the row-split pass C P (kf_common.cuh) starts on the first
//    stage that lands, reading 16 bytes a thread; after the small-ny algebra
//    P' is formed from the resident P and written by 16-byte streaming
//    stores. P is read from memory once.
//  - streaming (bf16 beyond 64 KB): the same block without the slab, so
//    several particles share an SM; pass 1 reads P 16 bytes a thread asking
//    L2 to keep the lines, pass 2 reads them again as their last use.
//  - two-pass (f32 beyond 64 KB, and rows of more than 256 16-byte units):
//    P streamed row by row in 8-byte pairs for C P and again for P'.
// A thread block cluster per particle (row slabs resident in up to 8
// blocks, partial C P summed through distributed shared memory) was slower
// than the two-pass form at nl=512 f32 on the H100 and is not kept: a
// particle's blocks start and wait together, so the SMs idle in step.
// P' is always a new tensor: several particles read the same ancestor.

#pragma once

#include "kf_common.cuh"

namespace {

constexpr int kBgThreads = kRowThreads;
constexpr size_t kBgResidentBytes = 64 * 1024;   // P held in shared memory
constexpr int kBgStageBytes = 8192;
constexpr int kBgMaxStages = 8;                  // kBgResidentBytes / kBgStageBytes
constexpr float kLog2Pi = 1.8378770664093453f;

// max that propagates NaN, as torch.maximum and jnp.maximum do (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Pivots of the ny <= 3 Cholesky recursion of the matrix with diagonal
// (a11, a22, a33) and off-diagonal entries s21, s31, s32.
template <int NY>
__device__ void chol_pivots(float a11, float a22, float a33, float s21,
                            float s31, float s32, float p[3]) {
  const float l11 = sqrtf(nan_max(a11, 1e-30f));
  const float l21 = s21 / l11;
  p[0] = a11;
  p[1] = a22 - l21 * l21;
  if (NY == 3) {
    const float l31 = s31 / l11;
    const float l22 = sqrtf(nan_max(p[1], 1e-30f));
    const float l32 = (s32 - l31 * l21) / l22;
    p[2] = a33 - l31 * l31 - l32 * l32;
  }
}

// S^-1, log|S| and the repair flag of one small SPD matrix (lower triangle
// of s used), with the repair of rbslam_tpu/kernels/kf_update.py:
// _spd_inv_logdet: scale = max(1, tr/ny); bad where a pivot <= 1e-30 scale;
// there the shift jitter*scale + max(Gershgorin excess, 0); shifted pivots
// clamped to the floor, so the outputs are finite for finite S.
template <int NY>
__device__ void spd_inv_logdet(const float s[3][3], float jitter,
                               float Sinv[3][3], float* logdet, bool* bad) {
  if (NY == 1) {
    const float s11 = s[0][0];
    const float scale = nan_max(1.0f, s11);
    *bad = s11 <= 1e-30f * scale;
    const float j = *bad ? jitter * scale + nan_max(-s11, 0.0f) : 0.0f;
    const float ssh = nan_max(s11 + j, 1e-30f * scale);
    Sinv[0][0] = 1.0f / ssh;
    *logdet = logf(ssh);
    return;
  }
  const float s11 = s[0][0], s21 = s[1][0], s22 = s[1][1];
  const float s31 = NY == 3 ? s[2][0] : 0.0f;
  const float s32 = NY == 3 ? s[2][1] : 0.0f;
  const float s33 = NY == 3 ? s[2][2] : 0.0f;
  const float tr = NY == 3 ? (s11 + s22) + s33 : s11 + s22;
  const float scale = nan_max(1.0f, tr / NY);
  const float floor_ = 1e-30f * scale;
  float p[3];
  chol_pivots<NY>(s11, s22, s33, s21, s31, s32, p);
  bool b = p[0] <= floor_ || p[1] <= floor_;
  if (NY == 3) b = b || p[2] <= floor_;
  float g;
  if (NY == 2) {
    g = nan_max(fabsf(s21) - s11, fabsf(s21) - s22);
  } else {
    g = nan_max(fabsf(s21) + fabsf(s31) - s11,
                nan_max(fabsf(s21) + fabsf(s32) - s22,
                        fabsf(s31) + fabsf(s32) - s33));
  }
  const float j = b ? jitter * scale + nan_max(g, 0.0f) : 0.0f;
  chol_pivots<NY>(s11 + j, s22 + j, s33 + j, s21, s31, s32, p);
  float ld = 0.0f;
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    p[i] = nan_max(p[i], floor_);
    ld += logf(p[i]);
  }
  const float l11 = sqrtf(p[0]);
  const float l21 = s21 / l11;
  const float l22 = sqrtf(p[1]);
  const float m11 = 1.0f / l11, m22 = 1.0f / l22;
  const float m21 = -l21 * m11 * m22;
  if (NY == 2) {
    Sinv[0][0] = m11 * m11 + m21 * m21;
    Sinv[1][0] = Sinv[0][1] = m21 * m22;
    Sinv[1][1] = m22 * m22;
  } else {
    const float l31 = s31 / l11;
    const float l32 = (s32 - l31 * l21) / l22;
    const float l33 = sqrtf(p[2]);
    const float m33 = 1.0f / l33;
    const float m32 = -l32 * m22 * m33;
    const float m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33;
    Sinv[0][0] = m11 * m11 + m21 * m21 + m31 * m31;
    Sinv[1][0] = Sinv[0][1] = m21 * m22 + m31 * m32;
    Sinv[2][0] = Sinv[0][2] = m31 * m33;
    Sinv[1][1] = m22 * m22 + m32 * m32;
    Sinv[2][1] = Sinv[1][2] = m32 * m33;
    Sinv[2][2] = m33 * m33;
  }
  *logdet = ld;
  *bad = b;
}

// S = CP C^T + R from warp reductions, then the closed form on one thread:
// logw and bad (written by `writer`), S^-1 into s_inv. Every thread calls it.
template <int NY>
__device__ void innovation_algebra(const float* CP, const float* Cf,
                                   const float* __restrict__ R,
                                   const float* s_e, float* s_red,
                                   float (*s_inv)[3], int nl, float jitter,
                                   float* logw, unsigned char* bad,
                                   bool writer) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kEntries = NY * (NY + 1) / 2;
  if (warp < kEntries) {
    const int i = warp < 1 ? 0 : (warp < 3 ? 1 : 2);
    const int j = warp - i * (i + 1) / 2;
    float acc = 0.0f;
    for (int k = lane; k < nl; k += 32) acc = fmaf(CP[i * nl + k], Cf[j * nl + k], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_red[warp] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float s[3][3] = {};
    for (int i = 0; i < NY; ++i)
      for (int j = 0; j <= i; ++j) s[i][j] = s_red[i * (i + 1) / 2 + j] + R[i * NY + j];
    float Sinv[3][3] = {};
    float logdet;
    bool is_bad;
    spd_inv_logdet<NY>(s, jitter, Sinv, &logdet, &is_bad);
    float quad = 0.0f;
    for (int j = 0; j < NY; ++j) {
      float eS = 0.0f;
      for (int i = 0; i < NY; ++i) eS = fmaf(s_e[i], Sinv[i][j], eS);
      quad = fmaf(eS, s_e[j], quad);
    }
    if (writer) {
      *logw = -0.5f * quad - 0.5f * logdet - 0.5f * NY * kLog2Pi;
      *bad = is_bad ? 1 : 0;
    }
    for (int i = 0; i < NY; ++i)
      for (int j = 0; j < NY; ++j) s_inv[i][j] = Sinv[i][j];
  }
  __syncthreads();
}

// Column k's gain rows and rounded CP: K5 K3 = round(S^-1 CP), Cr = round(CP)
// and the state step e^T S^-1 CP; K11 K = gain CP, Cr = CP.
template <typename T, int NY, bool kUpdate>
__device__ __forceinline__ float gain_column(const float* CP, float* Cr,
                                             float* K3, float (*s_inv)[3],
                                             const float* s_e, float gain,
                                             int nl, int k) {
  float cp[NY], step = 0.0f;
#pragma unroll
  for (int i = 0; i < NY; ++i) cp[i] = CP[i * nl + k];
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    if constexpr (kUpdate) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < NY; ++j) v = fmaf(s_inv[i][j], cp[j], v);
      step = fmaf(s_e[i], v, step);
      K3[i * nl + k] = storage_round<T>(v);
      Cr[i * nl + k] = storage_round<T>(cp[i]);
    } else {
      K3[i * nl + k] = gain * cp[i];
      Cr[i * nl + k] = cp[i];
    }
  }
  return step;
}

// the gain columns of 16-byte unit u: kk[i][c] = K3[i][u E + c]
template <int NY, int E>
__device__ __forceinline__ void load_gain_unit(const float* K3, int nl, int u,
                                               float (&kk)[NY][E]) {
#pragma unroll
  for (int i = 0; i < NY; ++i) {
#pragma unroll
    for (int c = 0; c < E; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(K3 + i * nl + u * E + c);
      kk[i][c] = v.x;
      kk[i][c + 1] = v.y;
      kk[i][c + 2] = v.z;
      kk[i][c + 3] = v.w;
    }
  }
}

// Unit u of row r of P' from row r of P (NaN where the ancestor is bad):
// P - round(sum_i Cr[i][r] kk[i]) (K11: unrounded), stored by a streaming
// 16-byte store.
// kLast: the rows lie in global memory and this is their last read.
template <typename T, int NY, bool kUpdate, bool kLast>
__device__ __forceinline__ void write_unit(const T* slab, T* Ob, const float* Cr,
                                           const float (&kk)[NY][Unit<T>::kElems],
                                           int nl, int r, int u, bool ok) {
  constexpr int E = Unit<T>::kElems;
  float p[E];
  if (ok) {
    if constexpr (kLast) {
      load_unit_last(slab + (size_t)r * nl + u * E, p);
    } else {
      load_unit(slab + (size_t)r * nl + u * E, p);
    }
  } else {
#pragma unroll
    for (int c = 0; c < E; ++c) p[c] = quiet_nan();
  }
  float d[E];
#pragma unroll
  for (int c = 0; c < E; ++c) d[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const float cr = Cr[i * nl + r];
#pragma unroll
    for (int c = 0; c < E; ++c) d[c] = fmaf(cr, kk[i][c], d[c]);
  }
#pragma unroll
  for (int c = 0; c < E; ++c) p[c] -= kUpdate ? storage_round<T>(d[c]) : d[c];
  store_unit_stream(Ob + (size_t)r * nl + u * E, p);
}

enum : int { kBgTwoPass = 0, kBgResident = 1, kBgStreaming = 2 };

struct BgPlan {
  int form;         // kBgTwoPass, kBgResident or kBgStreaming
  int stage_rows;   // rows of P a bulk copy (resident form)
  size_t smem;      // dynamic shared memory a block
};

// Which form runs at (ny, nl, itemsize); the wrapper's mirror is
// kernels/kf_update.py:_block_plan.
inline BgPlan block_gather_plan(int ny, int nl, int itemsize) {
  const size_t bytes = (size_t)nl * nl * itemsize;
  const int units = row_units(nl, itemsize);
  const size_t extras = 4 * (size_t)ny * nl * (4 + row_sets(units));
  if (units <= kRowThreads) {
    if (bytes <= kBgResidentBytes && bytes + extras <= kSmemBudget) {
      int rows = kBgStageBytes / (nl * itemsize);
      if (rows < 1) rows = 1;
      if (rows > nl) rows = nl;
      if ((nl + rows - 1) / rows > kBgMaxStages) rows = (nl + kBgMaxStages - 1) / kBgMaxStages;
      return {kBgResident, rows, bytes + extras};
    }
    if (itemsize == 2 && extras <= kSmemBudget) return {kBgStreaming, 0, extras};
  }
  int groups = kBgThreads / (nl / 2);
  if (groups < 1) groups = 1;
  return {kBgTwoPass, 0, 4 * (size_t)ny * nl * (3 + groups)};
}

// The resident and streaming forms: one block of 256 threads per particle.
// kResident: P comes into shared memory by bulk copies in stages, each on
// its own mbarrier; pass 1 starts on the first stage that lands and pass 2
// forms P' from the resident P (P read once). Streaming: pass 1 reads P from
// global memory, asking L2 to keep the lines, and pass 2 reads it again as
// their last use.
template <typename T, int NY, bool kUpdate, bool kResident>
__global__ void __launch_bounds__(kBgThreads)
block_slab_kernel(const int* __restrict__ ai, const float* __restrict__ C,
                  const float* __restrict__ e, const float* __restrict__ xl,
                  const T* __restrict__ P_all, const float* __restrict__ R,
                  T* __restrict__ P_out, float* __restrict__ xl_out,
                  float* __restrict__ logw_out,
                  unsigned char* __restrict__ bad_out, long long n_all,
                  int nl, int stage_rows, float jitter, float gain) {
  constexpr int E = Unit<T>::kElems;
  extern __shared__ __align__(128) unsigned char bg_smem[];
  __shared__ uint64_t full[kBgMaxStages];
  __shared__ float s_red[6];
  __shared__ float s_inv[3][3];
  __shared__ float s_e[3];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const int n_st = kResident ? (nl + stage_rows - 1) / stage_rows : 0;
  const int units = row_units(nl, sizeof(T));
  const int sets = row_sets(units);
  const size_t slab_bytes = kResident ? (size_t)nl * nl * sizeof(T) : 0;
  float* Cr = reinterpret_cast<float*>(bg_smem + slab_bytes);
  float* Cf = Cr + NY * nl;       // [NY][nl] C in f32
  float* CP = Cf + NY * nl;       // [NY][nl] C P
  float* K3 = CP + NY * nl;       // [NY][nl] round(K3) (K11: gain CP)
  float* part = K3 + NY * nl;     // [sets][NY][nl] partial sums
  long long src = b;
  bool ok = true;
  if constexpr (kUpdate) {
    src = ai[b];
    ok = src >= 0 && src < n_all;
  }
  // P in shared memory, or where it lies
  const T* from = P_all + (ok ? src : 0) * (long long)nl * nl;
  const T* Ps = kResident ? reinterpret_cast<const T*>(bg_smem) : from;
  if (kResident && tid == 0) {
    for (int s = 0; s < n_st; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    if (ok) {
      for (int s = 0; s < n_st; ++s) {
        const int r = min(stage_rows, nl - s * stage_rows);
        const uint32_t bytes = (uint32_t)((size_t)r * nl * sizeof(T));
        mbar_arrive_expect_tx(&full[s], bytes);
        bulk_load(bg_smem + (size_t)s * stage_rows * nl * sizeof(T),
                  from + (long long)s * stage_rows * nl, bytes, &full[s]);
      }
    }
  }
  const float* Cb = C + b * NY * nl;
  for (int i = tid; i < NY * nl; i += kBgThreads) {
    const float c = Cb[i];
    Cf[i] = c;
    Cr[i] = kUpdate ? storage_round<T>(c) : c;
  }
  if (kUpdate && tid < NY) s_e[tid] = e[b * NY + tid];
  __syncthreads();

  // pass 1 (resident: stage by stage as they land)
  const RowSplit rs(nl, sizeof(T), tid);
  float acc[NY][E];
#pragma unroll
  for (int i = 0; i < NY; ++i) {
#pragma unroll
    for (int c = 0; c < E; ++c) acc[i][c] = ok ? 0.0f : quiet_nan();
  }
  if (ok) {
    if constexpr (kResident) {
      for (int s = 0; s < n_st; ++s) {
        mbar_wait(&full[s], 0);
        const int j0 = s * stage_rows;
        cp_rows<T, NY>(Ps + (size_t)j0 * nl, j0, min(nl, j0 + stage_rows), nl,
                       rs, Cr, nl, acc);
      }
    } else {
      cp_rows<T, NY, true>(Ps, 0, nl, nl, rs, Cr, nl, acc);
    }
  }
  cp_partial_store<NY, E>(acc, rs, part, nl, lane);
  __syncthreads();
  for (int idx = tid; idx < NY * nl; idx += kBgThreads) {
    CP[idx] = cp_partial_sum<NY>(part, sets, nl, idx);
  }
  __syncthreads();

  if constexpr (kUpdate) {
    innovation_algebra<NY>(CP, Cf, R, s_e, s_red, s_inv, nl, jitter,
                           logw_out + b, bad_out + b, true);
  }
  for (int k = tid; k < nl; k += kBgThreads) {
    const float step = gain_column<T, NY, kUpdate>(CP, Cr, K3, s_inv, s_e,
                                                   gain, nl, k);
    if (kUpdate) xl_out[b * nl + k] = xl[b * nl + k] + step;
  }
  __syncthreads();

  // pass 2: P', 16 bytes a thread; where the unit count divides the block,
  // a thread keeps one unit and holds its K3 columns in registers across
  // its rows
  T* Ob = P_out + b * (long long)nl * nl;
  float kk[NY][E];
  if (kBgThreads % units == 0) {
    const int u = tid % units;
    load_gain_unit<NY, E>(K3, nl, u, kk);
    for (int r = tid / units; r < nl; r += kBgThreads / units) {
      write_unit<T, NY, kUpdate, !kResident>(Ps, Ob, Cr, kk, nl, r, u, ok);
    }
  } else {
    for (int item = tid; item < nl * units; item += kBgThreads) {
      const int r = item / units, u = item - r * units;
      load_gain_unit<NY, E>(K3, nl, u, kk);
      write_unit<T, NY, kUpdate, !kResident>(Ps, Ob, Cr, kk, nl, r, u, ok);
    }
  }
}

// The two-pass form: one block of 256 threads per particle. Pass 1 streams
// P row by row, each thread on a column pair and one of `groups` interleaved
// row slices (groups = 256 / (nl/2)); the slices' partial sums meet in shared
// memory. Pass 2 reads P again and writes P' row by row.
template <typename T, int NY, bool kUpdate>
__global__ void __launch_bounds__(kBgThreads)
block_two_pass_kernel(const int* __restrict__ ai, const float* __restrict__ C,
                      const float* __restrict__ e, const float* __restrict__ xl,
                      const T* __restrict__ P_all, const float* __restrict__ R,
                      T* __restrict__ P_out, float* __restrict__ xl_out,
                      float* __restrict__ logw_out,
                      unsigned char* __restrict__ bad_out, long long n_all,
                      int nl, int groups, float jitter, float gain) {
  extern __shared__ float4 smem_raw[];
  float* Cr = reinterpret_cast<float*>(smem_raw);  // [NY][nl] Cr, later round(CP)
  float* Cf = Cr + NY * nl;            // [NY][nl] C in f32
  float* CP = Cf + NY * nl;            // [groups][NY][nl] partial sums; [0] = CP
  float* K3 = CP + groups * NY * nl;   // [NY][nl] round(K3) (K11: gain CP)
  __shared__ float s_red[6];
  __shared__ float s_inv[3][3];
  __shared__ float s_e[3];

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Cb = C + b * NY * nl;
  for (int i = tid; i < NY * nl; i += blockDim.x) {
    const float c = Cb[i];
    Cf[i] = c;
    Cr[i] = kUpdate ? storage_round<T>(c) : c;
  }
  if (kUpdate && tid < NY) s_e[tid] = e[b * NY + tid];
  long long src = b;
  bool ok = true;
  if constexpr (kUpdate) {
    src = ai[b];
    ok = src >= 0 && src < n_all;
  }
  const T* Pb = P_all + (ok ? src : 0) * (long long)nl * nl;
  const float2 nan2 = make_float2(quiet_nan(), quiet_nan());
  __syncthreads();

  // pass 1: partial CP over the row slice j = g, g + groups, ...
  const int pairs = nl / 2;
  for (int item = tid; item < pairs * groups; item += blockDim.x) {
    const int k = 2 * (item % pairs);
    const int g = item / pairs;
    float acc[NY][2];
#pragma unroll
    for (int i = 0; i < NY; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll 4
    for (int j = g; j < nl; j += groups) {
      const float2 p = ok ? load_pair(Pb + (long long)j * nl + k) : nan2;
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        acc[i][0] = fmaf(Cr[i * nl + j], p.x, acc[i][0]);
        acc[i][1] = fmaf(Cr[i * nl + j], p.y, acc[i][1]);
      }
    }
    float* out = CP + g * NY * nl;
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      out[i * nl + k] = acc[i][0];
      out[i * nl + k + 1] = acc[i][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NY * nl; idx += blockDim.x) {
    float v = CP[idx];
    for (int g = 1; g < groups; ++g) v += CP[g * NY * nl + idx];
    CP[idx] = v;
  }
  __syncthreads();

  if constexpr (kUpdate) {
    innovation_algebra<NY>(CP, Cf, R, s_e, s_red, s_inv, nl, jitter,
                           logw_out + b, bad_out + b, true);
  }
  for (int k = tid; k < nl; k += blockDim.x) {
    const float step = gain_column<T, NY, kUpdate>(CP, Cr, K3, s_inv, s_e,
                                                   gain, nl, k);
    if (kUpdate) xl_out[b * nl + k] = xl[b * nl + k] + step;
  }
  __syncthreads();

  // pass 2: P' = P - round(round(CP)^T round(K3)) (K11: round(P - CP^T K)),
  // row by row, P read again
  T* Ob = P_out + b * (long long)nl * nl;
#pragma unroll 4
  for (int item = tid; item < nl * pairs; item += blockDim.x) {
    const int r = item / pairs;
    const int k = 2 * (item % pairs);
    const float2 p = ok ? load_pair(Pb + (long long)r * nl + k) : nan2;
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      const float c = Cr[i * nl + r];
      const float2 kk = *reinterpret_cast<const float2*>(K3 + i * nl + k);
      d0 = fmaf(c, kk.x, d0);
      d1 = fmaf(c, kk.y, d1);
    }
    if constexpr (kUpdate) {
      d0 = storage_round<T>(d0);
      d1 = storage_round<T>(d1);
    }
    store_pair(Ob + (long long)r * nl + k, p.x - d0, p.y - d1);
  }
}

// The resident or streaming form on n particles, a block each.
template <typename T, int NY, bool kUpdate, bool kResident>
cudaError_t launch_slab(const BgPlan& plan, const int* ai, const float* C,
                        const float* e, const float* xl, const T* P,
                        const float* R, T* P_out, float* xl_out, float* logw,
                        unsigned char* bad, long long n, long long n_all,
                        int nl, float jitter, float gain, cudaStream_t s) {
  cudaError_t err = allow_smem(block_slab_kernel<T, NY, kUpdate, kResident>, plan.smem);
  if (err != cudaSuccess) return err;
  block_slab_kernel<T, NY, kUpdate, kResident><<<(unsigned)n, kBgThreads, plan.smem, s>>>(
      ai, C, e, xl, P, R, P_out, xl_out, logw, bad, n_all, nl, plan.stage_rows,
      jitter, gain);
  return cudaGetLastError();
}

// Launch K5 (kUpdate) or K11 on n particles (n > 0) in the form
// `form` (block_gather_plan's form: the wrapper's mirror of it).
// K11 passes ai, e, xl, R, xl_out, logw and bad as nullptr.
template <typename T, int NY, bool kUpdate>
cudaError_t launch_block_kernel(const void* ai, const void* C, const void* e,
                                const void* xl, const void* P_all,
                                const void* R, void* P_out, void* xl_out,
                                void* logw, void* bad, long long n,
                                long long n_all, int nl, int form,
                                float jitter, float gain, cudaStream_t s) {
  const BgPlan plan = block_gather_plan(NY, nl, sizeof(T));
  if (form != plan.form || plan.smem > kSmemBudget)
    return cudaErrorInvalidValue;
  const int* ai_ = static_cast<const int*>(ai);
  const float* C_ = static_cast<const float*>(C);
  const float* e_ = static_cast<const float*>(e);
  const float* xl_ = static_cast<const float*>(xl);
  const T* P_ = static_cast<const T*>(P_all);
  const float* R_ = static_cast<const float*>(R);
  T* Pout_ = static_cast<T*>(P_out);
  float* xlout_ = static_cast<float*>(xl_out);
  float* logw_ = static_cast<float*>(logw);
  unsigned char* bad_ = static_cast<unsigned char*>(bad);
  cudaError_t err;
  if (plan.form == kBgTwoPass) {
    int groups = kBgThreads / (nl / 2);
    if (groups < 1) groups = 1;
    err = allow_smem(block_two_pass_kernel<T, NY, kUpdate>, plan.smem);
    if (err != cudaSuccess) return err;
    block_two_pass_kernel<T, NY, kUpdate><<<(unsigned)n, kBgThreads, plan.smem, s>>>(
        ai_, C_, e_, xl_, P_, R_, Pout_, xlout_, logw_, bad_, n_all, nl, groups,
        jitter, gain);
    return cudaGetLastError();
  }
  if (plan.form == kBgResident) {
    return launch_slab<T, NY, kUpdate, true>(plan, ai_, C_, e_, xl_, P_, R_, Pout_,
                                             xlout_, logw_, bad_, n, n_all, nl,
                                             jitter, gain, s);
  }
  return launch_slab<T, NY, kUpdate, false>(plan, ai_, C_, e_, xl_, P_, R_, Pout_,
                                            xlout_, logw_, bad_, n, n_all, nl,
                                            jitter, gain, s);
}

}  // namespace
