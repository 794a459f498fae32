// Kalman update kernels for Hopper (sm_90a): the gathered dense update (K5)
// and the factored-covariance update (K2, K3).
//
// K5 block_gather  replaces rbslam_tpu/kernels/kf_update.py:_kernel_block_gather
//   (its math is _block_update_math, its repair _spd_inv_logdet). Per
//   particle b, with P = P_all[ai[b]] the ancestor's covariance:
//     CP = round(C) P (f32 sums)   S = CP C^T + R   (S^-1, log|S|, bad) by the
//     closed-form ny <= 3 Cholesky with the Gershgorin repair
//     logw = -1/2 e^T S^-1 e - 1/2 log|S| - ny/2 log 2pi
//     K3 = S^-1 CP   xl' = xl + e^T K3   P' = P - round(round(CP)^T round(K3))
//   where round() is the storage dtype's rounding.
//   Bound: one gathered read plus one write of P per step,
//   2*N*nl*nl*itemsize bytes: 1.07 GB at N=16384, nl=128, bf16 (>= 0.32 ms
//   at 3.35 TB/s); 8.6 GB at N=4096, nl=512, f32. Design: one block of 256
//   threads per particle, which reads ai[b] itself and stages C[b] (f32 and
//   rounded) and e[b] in shared memory. Pass 1 streams P row by row, each
//   thread on a column pair and one of `groups` interleaved row slices
//   (groups = 256 / (nl/2), so every thread has work at nl=128), so each
//   row is one coalesced read; the row slices' partial CP are summed in
//   shared memory. S comes from warp reductions, one thread runs the
//   closed form, then K3 and xl' are formed per column. Pass 2 writes P'
//   row by row, coalesced. Where P fits in shared memory beside the rest
//   (nl=128: 32 KB bf16, 64 KB f32) pass 1 keeps it there and pass 2 reads
//   it back from shared memory; otherwise (nl=512 f32 is 1 MB) pass 2 reads
//   P again from global memory, in part from L2. P' is a new tensor: several
//   particles read the same ancestor.
//
// The filter carries each particle's covariance as P = P_base[bidx] - Wt^T Wt
// (P_base read-only between rebases, Wt [rw, nl] the accumulated factor rows).
//
// K2 gather_cp  replaces rbslam_tpu/kernels/kf_update.py:_kernel_gather_cp
//     CP[b] = C[b] P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]     -> [N, ny, nl] f32
//   Bound: reading the gathered ancestor rows of P_base, N*nl*nl*itemsize
//   bytes per step (0.54 GB at N=16384, nl=128, bf16). Design: one block
//   per particle; the block stages C[b] (f32) in shared memory, forms the
//   small C Wt^T [ny, rw] by warp reductions (rounded to the storage dtype,
//   as the reference rounds it), then streams P_base[bidx[b]] row by row
//   with each thread on a pair of adjacent columns (one 4- or 8-byte load
//   per row), so each row is one coalesced read and every element of the
//   gathered matrix is read exactly once. No gathered copy of P_base is
//   ever written to device memory.
//
// K3 rebase  replaces rbslam_tpu/kernels/kf_update.py:_kernel_rebase
//     P'[b] = P_base[bidx[b]] - round(Wt[b]^T Wt[b])                -> [N, nl, nl]
//   Bound: its bytes, one read of the gathered P_base rows plus one write
//   of P' (2*N*nl*nl*itemsize per rebase); the rank-rw product adds 2*rw
//   flops per element, which the tensor cores (bf16) or f32 FMA must hide
//   under the copy. Design (rebase_kernel<T, true, true> of kf_common.cuh):
//   one block per particle; a producer warp brings Wt[b] and the ancestor's
//   matrix, in row blocks through a four-stage shared-memory ring, by
//   asynchronous bulk copies (mbarriers); eight consumer warps
//   form Wt^T Wt for the rows at hand, at bf16 by mma.sync.m16n8k16 with f32
//   accumulation on operands from ldmatrix.trans, at f32 by FMA on 4 x 4
//   register blocks (no TF32), round it to the storage dtype, subtract and
//   store 16 bytes a thread. The output is a new tensor: several particles
//   read the same ancestor row of P_base, so it can never be updated in
//   place.
//
// nl must be a multiple of 8 (the engine pads it to a multiple of 128);
// K3 needs P_base, Wt and P_out 16-byte aligned (bulk copies).
// All offsets are 64-bit (N*nl*nl exceeds 2^31 at 131k particles). An
// ancestor or base index outside [0, n_base) writes NaN into that
// particle's output instead of reading out of bounds, so a bad index shows
// up in the weights.

#include "kf_common.cuh"

namespace {

// ---------------------------------------------------------------- K5 ----

constexpr int kBlockThreads = 256;
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

template <typename T, int NY>
__global__ void __launch_bounds__(kBlockThreads)
block_gather_kernel(const int* __restrict__ ai, const float* __restrict__ C,
                    const float* __restrict__ e, const float* __restrict__ xl,
                    const T* __restrict__ P_all, const float* __restrict__ R,
                    T* __restrict__ P_out, float* __restrict__ xl_out,
                    float* __restrict__ logw_out,
                    unsigned char* __restrict__ bad_out, long long n_all,
                    int nl, int groups, int stash, float jitter) {
  extern __shared__ float4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  T* Ps = reinterpret_cast<T*>(smem);  // [nl][nl] ancestor P, when stashed
  float* Cr = reinterpret_cast<float*>(
      smem + (stash ? (size_t)nl * nl * sizeof(T) : 0));  // [NY][nl] round(C), later round(CP)
  float* Cf = Cr + NY * nl;            // [NY][nl] C in f32
  float* CP = Cf + NY * nl;            // [groups][NY][nl] partial sums; [0] = CP
  float* K3 = CP + groups * NY * nl;   // [NY][nl] round(K3)
  __shared__ float s_red[6];
  __shared__ float s_inv[3][3];
  __shared__ float s_e[3];

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Cb = C + b * NY * nl;
  for (int i = tid; i < NY * nl; i += blockDim.x) {
    const float c = Cb[i];
    Cf[i] = c;
    Cr[i] = storage_round<T>(c);
  }
  if (tid < NY) s_e[tid] = e[b * NY + tid];
  const long long src = ai[b];
  const bool ok = src >= 0 && src < n_all;
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
      if (stash) store_pair(Ps + j * nl + k, p.x, p.y);  // exact: p holds T values
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

  // S = CP C^T (lower triangle): one warp per entry
  const int warp = tid >> 5, lane = tid & 31;
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
    bool bad;
    spd_inv_logdet<NY>(s, jitter, Sinv, &logdet, &bad);
    float quad = 0.0f;
    for (int j = 0; j < NY; ++j) {
      float eS = 0.0f;
      for (int i = 0; i < NY; ++i) eS = fmaf(s_e[i], Sinv[i][j], eS);
      quad = fmaf(eS, s_e[j], quad);
    }
    logw_out[b] = -0.5f * quad - 0.5f * logdet - 0.5f * NY * kLog2Pi;
    bad_out[b] = bad ? 1 : 0;
    for (int i = 0; i < NY; ++i)
      for (int j = 0; j < NY; ++j) s_inv[i][j] = Sinv[i][j];
  }
  __syncthreads();

  // K3 = S^-1 CP and xl' = xl + e^T K3, per column; keep round(CP), round(K3)
  for (int k = tid; k < nl; k += blockDim.x) {
    float cp[NY], step = 0.0f;
#pragma unroll
    for (int i = 0; i < NY; ++i) cp[i] = CP[i * nl + k];
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < NY; ++j) v = fmaf(s_inv[i][j], cp[j], v);
      step = fmaf(s_e[i], v, step);
      K3[i * nl + k] = storage_round<T>(v);
      Cr[i * nl + k] = storage_round<T>(cp[i]);
    }
    xl_out[b * nl + k] = xl[b * nl + k] + step;
  }
  __syncthreads();

  // pass 2: P' = P - round(round(CP)^T round(K3)), row by row
  T* Ob = P_out + b * (long long)nl * nl;
#pragma unroll 4
  for (int item = tid; item < nl * pairs; item += blockDim.x) {
    const int r = item / pairs;
    const int k = 2 * (item % pairs);
    const float2 p = stash ? load_pair(Ps + r * nl + k)
                           : (ok ? load_pair(Pb + (long long)r * nl + k) : nan2);
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      const float c = Cr[i * nl + r];
      const float2 kk = *reinterpret_cast<const float2*>(K3 + i * nl + k);
      d0 = fmaf(c, kk.x, d0);
      d1 = fmaf(c, kk.y, d1);
    }
    store_pair(Ob + (long long)r * nl + k, p.x - storage_round<T>(d0),
               p.y - storage_round<T>(d1));
  }
}

template <typename T, int NY>
cudaError_t launch_gather_cp(const void* bidx, const void* C, const void* Wt,
                             const void* P_base, void* CP, long long n,
                             long long n_base, int rw, int nl,
                             cudaStream_t s) {
  int threads = ((nl / 2 + 31) / 32) * 32;  // one thread per column pair
  if (threads > 256) threads = 256;
  const size_t smem = (size_t)(NY * nl + NY * rw) * sizeof(float);
  cudaError_t err = allow_smem(gather_cp_kernel<T, T, NY, true>, smem);
  if (err != cudaSuccess) return err;
  gather_cp_kernel<T, T, NY, true><<<(unsigned)n, threads, smem, s>>>(
      static_cast<const int*>(bidx), static_cast<const T*>(C),
      static_cast<const T*>(Wt), static_cast<const T*>(P_base),
      static_cast<float*>(CP), n_base, rw, nl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gather_cp_ny(int ny, const void* bidx, const void* C,
                                const void* Wt, const void* P_base, void* CP,
                                long long n, long long n_base, int rw, int nl,
                                cudaStream_t s) {
  switch (ny) {
    case 1: return launch_gather_cp<T, 1>(bidx, C, Wt, P_base, CP, n, n_base, rw, nl, s);
    case 2: return launch_gather_cp<T, 2>(bidx, C, Wt, P_base, CP, n, n_base, rw, nl, s);
    case 3: return launch_gather_cp<T, 3>(bidx, C, Wt, P_base, CP, n, n_base, rw, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NY>
cudaError_t launch_block_gather(const void* ai, const void* C, const void* e,
                                const void* xl, const void* P_all,
                                const void* R, void* P_out, void* xl_out,
                                void* logw, void* bad, long long n,
                                long long n_all, int nl, float jitter,
                                cudaStream_t s) {
  int groups = kBlockThreads / (nl / 2);
  if (groups < 1) groups = 1;
  const size_t fbytes = (size_t)NY * nl * (3 + groups) * sizeof(float);
  const size_t pbytes = (size_t)nl * nl * sizeof(T);
  const int stash = fbytes + pbytes <= kStashBytes;
  const size_t smem = fbytes + (stash ? pbytes : 0);
  cudaError_t err = allow_smem(block_gather_kernel<T, NY>, smem);
  if (err != cudaSuccess) return err;
  block_gather_kernel<T, NY><<<(unsigned)n, kBlockThreads, smem, s>>>(
      static_cast<const int*>(ai), static_cast<const float*>(C),
      static_cast<const float*>(e), static_cast<const float*>(xl),
      static_cast<const T*>(P_all), static_cast<const float*>(R),
      static_cast<T*>(P_out), static_cast<float*>(xl_out),
      static_cast<float*>(logw), static_cast<unsigned char*>(bad), n_all, nl,
      groups, stash, jitter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block_gather_ny(int ny, const void* ai, const void* C,
                                   const void* e, const void* xl,
                                   const void* P_all, const void* R,
                                   void* P_out, void* xl_out, void* logw,
                                   void* bad, long long n, long long n_all,
                                   int nl, float jitter, cudaStream_t s) {
  switch (ny) {
    case 1: return launch_block_gather<T, 1>(ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, jitter, s);
    case 2: return launch_block_gather<T, 2>(ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, jitter, s);
    case 3: return launch_block_gather<T, 3>(ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, jitter, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbs_block_gather(const void* ai, const void* C, const void* e,
                                const void* xl, const void* P_all,
                                const void* R, void* P_out, void* xl_out,
                                void* logw, void* bad, long long n,
                                long long n_all, int ny, int nl, float jitter,
                                int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_block_gather_ny<__nv_bfloat16>(ny, ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, jitter, s)
           : launch_block_gather_ny<float>(ny, ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, jitter, s);
  return (int)err;
}

extern "C" int rbs_gather_cp(const void* bidx, const void* C, const void* Wt,
                             const void* P_base, void* CP, long long n,
                             long long n_base, int ny, int rw, int nl,
                             int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_gather_cp_ny<__nv_bfloat16>(ny, bidx, C, Wt, P_base, CP, n, n_base, rw, nl, s)
           : launch_gather_cp_ny<float>(ny, bidx, C, Wt, P_base, CP, n, n_base, rw, nl, s);
  return (int)err;
}

extern "C" int rbs_rebase(const void* bidx, const void* Wt, const void* P_base,
                          void* P_out, long long n, long long n_base, int rw,
                          int nl, int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_rebase_kernel<__nv_bfloat16, true, true>(bidx, Wt, P_base, P_out, n, n_base, rw, nl, s)
           : launch_rebase_kernel<float, true, true>(bidx, Wt, P_base, P_out, n, n_base, rw, nl, s);
  return (int)err;
}
