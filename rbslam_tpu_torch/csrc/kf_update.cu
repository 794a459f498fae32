// Factored-covariance Kalman update kernels for Hopper (sm_90a).
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
//   Bound: one read of the gathered P_base rows plus one write of P'
//   (2*N*nl*nl*itemsize bytes per rebase); the rank-rw product adds
//   2*rw flops per element. Design: one block per particle with Wt[b]
//   staged once in shared memory (f32); each thread takes items of 8 rows
//   x 2 adjacent columns, issues the item's 8 paired loads of P_base first,
//   forms the 16 dot products in f32 from shared memory (the column pair
//   in one 8-byte read, the row entries broadcast across the warp), rounds
//   them to the storage dtype and subtracts. The output is a new tensor:
//   several particles read the same ancestor row of P_base, so it can
//   never be updated in place.
//
// nl must be a multiple of 8 (the engine pads it to a multiple of 128).
// All offsets are 64-bit (N*nl*nl exceeds 2^31 at 131k particles). A base
// index outside [0, n_base) writes NaN into that particle's output instead
// of reading out of bounds, so a bad index shows up in the weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two adjacent elements (8- or 4-byte aligned: even offsets only)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// round a float32 value to the storage dtype and back
template <typename T>
__device__ __forceinline__ float storage_round(float v) {
  return to_float<T>(from_float<T>(v));
}

template <typename T, int NY>
__global__ void gather_cp_kernel(const int* __restrict__ bidx,
                                 const T* __restrict__ C,
                                 const T* __restrict__ Wt,
                                 const T* __restrict__ P_base,
                                 float* __restrict__ CP, long long n_base,
                                 int rw, int nl) {
  extern __shared__ float smem[];
  float* Cs = smem;             // [NY][nl]
  float* CWt = smem + NY * nl;  // [NY][rw]
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* Cb = C + b * NY * nl;
  const T* Wb = Wt + b * (long long)rw * nl;
  for (int i = tid; i < NY * nl; i += blockDim.x) Cs[i] = to_float<T>(Cb[i]);
  __syncthreads();

  // C Wt^T [NY, rw]: one warp per factor row r, lanes over the column j
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rw; r += nwarps) {
    float acc[NY];
#pragma unroll
    for (int i = 0; i < NY; ++i) acc[i] = 0.0f;
    for (int j = lane; j < nl; j += 32) {
      const float w = to_float<T>(Wb[(long long)r * nl + j]);
#pragma unroll
      for (int i = 0; i < NY; ++i) acc[i] = fmaf(Cs[i * nl + j], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NY; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NY; ++i) CWt[i * rw + r] = storage_round<T>(acc[i]);
    }
  }
  __syncthreads();

  const long long src = bidx[b];
  const bool ok = src >= 0 && src < n_base;
  const T* Pb = P_base + (ok ? src : 0) * (long long)nl * nl;
  float* out = CP + b * NY * nl;
  for (int k = 2 * tid; k < nl; k += 2 * blockDim.x) {
    float acc[NY][2];
#pragma unroll
    for (int i = 0; i < NY; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < nl; ++j) {
      const float2 p = load_pair(Pb + (long long)j * nl + k);
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        acc[i][0] = fmaf(Cs[i * nl + j], p.x, acc[i][0]);
        acc[i][1] = fmaf(Cs[i * nl + j], p.y, acc[i][1]);
      }
    }
    float corr[NY][2];
#pragma unroll
    for (int i = 0; i < NY; ++i) corr[i][0] = corr[i][1] = 0.0f;
    for (int r = 0; r < rw; ++r) {
      const float2 w = load_pair(Wb + (long long)r * nl + k);
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        corr[i][0] = fmaf(CWt[i * rw + r], w.x, corr[i][0]);
        corr[i][1] = fmaf(CWt[i * rw + r], w.y, corr[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      store_pair(out + i * nl + k, ok ? acc[i][0] - corr[i][0] : quiet_nan(),
                 ok ? acc[i][1] - corr[i][1] : quiet_nan());
    }
  }
}

constexpr int kItemRows = 8;  // rows per rebase work item (x 2 columns)
constexpr int kRebaseThreads = 256;

template <typename T>
__global__ void rebase_kernel(const int* __restrict__ bidx,
                              const T* __restrict__ Wt,
                              const T* __restrict__ P_base,
                              T* __restrict__ P_out, long long n_base, int rw,
                              int nl) {
  extern __shared__ float Ws[];  // [rw][nl], Wt[b] in f32
  const long long b = blockIdx.x;
  const T* Wb = Wt + b * (long long)rw * nl;
  for (int i = threadIdx.x; i < rw * nl; i += blockDim.x) Ws[i] = to_float<T>(Wb[i]);
  __syncthreads();

  const long long src = bidx[b];
  const bool ok = src >= 0 && src < n_base;
  const T* Pb = P_base + (ok ? src : 0) * (long long)nl * nl;
  T* Ob = P_out + b * (long long)nl * nl;
  const int pairs = nl / 2;
  const int items = (nl / kItemRows) * pairs;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k = 2 * (item % pairs);
    const int j0 = (item / pairs) * kItemRows;
    float2 p[kItemRows];
#pragma unroll
    for (int rr = 0; rr < kItemRows; ++rr) {
      p[rr] = ok ? load_pair(Pb + (long long)(j0 + rr) * nl + k)
                 : make_float2(quiet_nan(), quiet_nan());
    }
    float dd[kItemRows][2];
#pragma unroll
    for (int rr = 0; rr < kItemRows; ++rr) dd[rr][0] = dd[rr][1] = 0.0f;
    for (int r = 0; r < rw; ++r) {
      const float2 wk = *reinterpret_cast<const float2*>(Ws + r * nl + k);
#pragma unroll
      for (int rr = 0; rr < kItemRows; ++rr) {
        const float wj = Ws[r * nl + j0 + rr];
        dd[rr][0] = fmaf(wj, wk.x, dd[rr][0]);
        dd[rr][1] = fmaf(wj, wk.y, dd[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kItemRows; ++rr) {
      store_pair(Ob + (long long)(j0 + rr) * nl + k,
                 p[rr].x - storage_round<T>(dd[rr][0]),
                 p[rr].y - storage_round<T>(dd[rr][1]));
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int NY>
cudaError_t launch_gather_cp(const void* bidx, const void* C, const void* Wt,
                             const void* P_base, void* CP, long long n,
                             long long n_base, int rw, int nl,
                             cudaStream_t s) {
  int threads = ((nl / 2 + 31) / 32) * 32;  // one thread per column pair
  if (threads > 256) threads = 256;
  const size_t smem = (size_t)(NY * nl + NY * rw) * sizeof(float);
  cudaError_t err = allow_smem(gather_cp_kernel<T, NY>, smem);
  if (err != cudaSuccess) return err;
  gather_cp_kernel<T, NY><<<(unsigned)n, threads, smem, s>>>(
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

template <typename T>
cudaError_t launch_rebase(const void* bidx, const void* Wt, const void* P_base,
                          void* P_out, long long n, long long n_base, int rw,
                          int nl, cudaStream_t s) {
  const size_t smem = (size_t)rw * nl * sizeof(float);
  cudaError_t err = allow_smem(rebase_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  rebase_kernel<T><<<(unsigned)n, kRebaseThreads, smem, s>>>(
      static_cast<const int*>(bidx), static_cast<const T*>(Wt),
      static_cast<const T*>(P_base), static_cast<T*>(P_out), n_base, rw, nl);
  return cudaGetLastError();
}

}  // namespace

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
      bf16 ? launch_rebase<__nv_bfloat16>(bidx, Wt, P_base, P_out, n, n_base, rw, nl, s)
           : launch_rebase<float>(bidx, Wt, P_base, P_out, n, n_base, rw, nl, s);
  return (int)err;
}
