// Laplacian-eigenbasis evaluation kernels for Hopper (sm_90a).
//
// K4 grad_basis  replaces rbslam_tpu/kernels/basis_eval.py:_grad_kernel
//     out[p, i, b] = scale * fac_ib cos(a_ib) prod_{j != i} sin(a_jb),
//     a_jb = freq_jb * x_pj + phase_jb                 ([N, 3] -> [N, 3, m] f32)
// K1 jac3d_rows  replaces rbslam_tpu/kernels/basis_eval.py:_jac3d_kernel
//     C[p, k, col] = sum_i R(q_p)[i, k] g_i[col],  g = [I_3 | grad phi(x_p) | 0]
//     ([N, 3] positions + [N, 4] quaternions -> [N, 3, nl_pad] f32 or bf16)
// K6 phi_basis   replaces rbslam_tpu/kernels/basis_eval.py:_phi_kernel
//     out[p, b] = scale * prod_j sin(a_jb)              ([N, d] -> [N, m] f32)
// K7 jac3d       replaces rbslam_tpu/kernels/basis_eval.py:_jac3d_kernel
//     K1's C in the transposed layout [3, N, nl_pad], f32 only
// K4 and K6 serve d in {1, 2, 3}.
//
// Bound: transcendental/ALU throughput (d sincosf or sinf per (particle,
// basis function)); the output write is d * m (K4), 3 * nl_pad (K1, K7)
// or m (K6) elements per particle. At the smoothers' ensemble sizes
// (N = 100) the launch itself is the floor.
// Design: one thread per (particle, column); adjacent threads take
// adjacent columns, so constant loads and output stores coalesce, and
// the three sin/cos pairs of a column are shared by the three gradient
// rows. The rotation is computed once per particle into shared memory.
// sincosf (full range reduction) is used on purpose: the phase arguments
// reach pi*n/2 + freq*x, where the fast intrinsics lose accuracy. The
// phase and the rotation-weighted sums are rounded operation by
// operation (no FMA contraction), as the plain PyTorch version rounds
// them, so kernel and plain version differ only by the sin/cos ulps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // threads along the column axis
constexpr int kRows = 2;    // particles per block

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float phase(float x, float freq, float ph) {
  return __fadd_rn(__fmul_rn(x, freq), ph);
}

template <int D>
__global__ void grad_basis_kernel(const float* __restrict__ x,
                                  const float* __restrict__ consts,
                                  float scale, float* __restrict__ out,
                                  long long n, int m) {
  const long long p = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= n || col >= m) return;
  float s[D], c[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float a = phase(x[p * D + j], __ldg(consts + (long long)j * m + col),
                          __ldg(consts + (long long)(D + j) * m + col));
    sincosf(a, &s[j], &c[j]);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float prod = __fmul_rn(__ldg(consts + (long long)(2 * D + i) * m + col), c[i]);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j != i) prod = __fmul_rn(prod, s[j]);
    }
    out[(p * D + i) * m + col] = __fmul_rn(scale, prod);
  }
}

// K6: the accumulator starts at scale and takes the sines left to right,
// as the plain version and the reference kernel do.
template <int D>
__global__ void phi_basis_kernel(const float* __restrict__ x,
                                 const float* __restrict__ consts,
                                 float scale, float* __restrict__ out,
                                 long long n, int m) {
  const long long p = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= n || col >= m) return;
  float acc = scale;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float a = phase(x[p * D + j], __ldg(consts + (long long)j * m + col),
                          __ldg(consts + (long long)(D + j) * m + col));
    acc = __fmul_rn(acc, sinf(a));
  }
  out[p * m + col] = acc;
}

// K1 and K7 share this kernel; kTransposed selects the store index:
// rows layout [N, 3, nl_pad] (K1) or [3, N, nl_pad] (K7).
template <typename OutT, bool kTransposed>
__global__ void jac3d_kernel(const float* __restrict__ pos,
                                  const float* __restrict__ quat,
                                  const float* __restrict__ consts,
                                  float scale, OutT* __restrict__ out,
                                  long long n, int m, int nl_pad) {
  __shared__ float Rs[kRows][9];
  const int ty = threadIdx.y;
  const long long p = (long long)blockIdx.x * kRows + ty;
  if (threadIdx.x == 0 && p < n) {
    const float q0 = quat[p * 4 + 0], q1 = quat[p * 4 + 1];
    const float q2 = quat[p * 4 + 2], q3 = quat[p * 4 + 3];
    const float a0 = __fmul_rn(q0, q0), a1 = __fmul_rn(q1, q1);
    const float a2 = __fmul_rn(q2, q2), a3 = __fmul_rn(q3, q3);
    // row-major R (math/quaternions.py::quat_to_rmat)
    Rs[ty][0] = __fsub_rn(__fsub_rn(__fadd_rn(a0, a1), a2), a3);
    Rs[ty][1] = 2.0f * __fsub_rn(__fmul_rn(q1, q2), __fmul_rn(q0, q3));
    Rs[ty][2] = 2.0f * __fadd_rn(__fmul_rn(q1, q3), __fmul_rn(q0, q2));
    Rs[ty][3] = 2.0f * __fadd_rn(__fmul_rn(q1, q2), __fmul_rn(q0, q3));
    Rs[ty][4] = __fsub_rn(__fadd_rn(__fsub_rn(a0, a1), a2), a3);
    Rs[ty][5] = 2.0f * __fsub_rn(__fmul_rn(q2, q3), __fmul_rn(q0, q1));
    Rs[ty][6] = 2.0f * __fsub_rn(__fmul_rn(q1, q3), __fmul_rn(q0, q2));
    Rs[ty][7] = 2.0f * __fadd_rn(__fmul_rn(q2, q3), __fmul_rn(q0, q1));
    Rs[ty][8] = __fadd_rn(__fsub_rn(__fsub_rn(a0, a1), a2), a3);
  }
  __syncthreads();
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (p >= n || col >= nl_pad) return;
  const float* R = Rs[ty];
  float C[3];
  if (col < 3) {
    // identity block of the linear kernel: C[k, col] = R[col, k]
#pragma unroll
    for (int k = 0; k < 3; ++k) C[k] = R[col * 3 + k];
  } else if (col < 3 + m) {
    const int b = col - 3;
    float s[3], c[3], g[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float a = phase(pos[p * 3 + j],
                            __ldg(consts + (long long)j * m + b),
                            __ldg(consts + (long long)(3 + j) * m + b));
      sincosf(a, &s[j], &c[j]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float prod = __fmul_rn(__ldg(consts + (long long)(6 + i) * m + b), c[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j != i) prod = __fmul_rn(prod, s[j]);
      }
      g[i] = __fmul_rn(scale, prod);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      C[k] = __fadd_rn(__fadd_rn(__fmul_rn(R[k], g[0]), __fmul_rn(R[3 + k], g[1])),
                       __fmul_rn(R[6 + k], g[2]));
    }
  } else {
    C[0] = C[1] = C[2] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long row = kTransposed ? (long long)k * n + p : p * 3 + k;
    out[row * nl_pad + col] = from_float<OutT>(C[k]);
  }
}

}  // namespace

extern "C" int rbs_grad_basis(const void* x, const void* consts, float scale,
                              void* out, long long n, int m, int d,
                              void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (m + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(consts);
  float* of = static_cast<float*>(out);
  switch (d) {
    case 1: grad_basis_kernel<1><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    case 2: grad_basis_kernel<2><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    case 3: grad_basis_kernel<3><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rbs_phi_basis(const void* x, const void* consts, float scale,
                             void* out, long long n, int m, int d,
                             void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (m + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(consts);
  float* of = static_cast<float*>(out);
  switch (d) {
    case 1: phi_basis_kernel<1><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    case 2: phi_basis_kernel<2><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    case 3: phi_basis_kernel<3><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rbs_jac3d_rows(const void* pos, const void* quat,
                              const void* consts, float scale, void* out,
                              long long n, int m, int nl_pad, int out_bf16,
                              void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (nl_pad + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(pos);
  const float* qf = static_cast<const float*>(quat);
  const float* cf = static_cast<const float*>(consts);
  if (out_bf16) {
    jac3d_kernel<__nv_bfloat16, false><<<grid, block, 0, s>>>(
        pf, qf, cf, scale, static_cast<__nv_bfloat16*>(out), n, m, nl_pad);
  } else {
    jac3d_kernel<float, false><<<grid, block, 0, s>>>(
        pf, qf, cf, scale, static_cast<float*>(out), n, m, nl_pad);
  }
  return (int)cudaGetLastError();
}

extern "C" int rbs_jac3d(const void* pos, const void* quat, const void* consts,
                         float scale, void* out, long long n, int m,
                         int nl_pad, void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (nl_pad + kCols - 1) / kCols);
  jac3d_kernel<float, true>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(pos), static_cast<const float*>(quat),
          static_cast<const float*>(consts), scale, static_cast<float*>(out),
          n, m, nl_pad);
  return (int)cudaGetLastError();
}
