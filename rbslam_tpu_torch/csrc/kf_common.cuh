// Device code shared by the Kalman update kernels (kf_update.cu) and the
// kernel-part probes (probes.cu): storage-dtype helpers, the gathered CP
// contraction (K2, and K8 with the factor term compiled out) and the rebase
// (K3, and K9 with its gather and its product switched separately). Each
// translation unit instantiates its own copies (anonymous namespace).

#pragma once

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

// keep a particle's P in shared memory up to here (2 blocks/SM)
constexpr size_t kStashBytes = 110 * 1024;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// CP[b] = round_T(C[b]) P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]   (K2)
// C is read as TC and rounded to T (the identity where TC = T); with
// kFactor false the factor term is compiled out and Wt is never read (K8).
// Dynamic shared memory: (NY*nl + (kFactor ? NY*rw : 0)) floats.
template <typename T, typename TC, int NY, bool kFactor>
__global__ void gather_cp_kernel(const int* __restrict__ bidx,
                                 const TC* __restrict__ C,
                                 const T* __restrict__ Wt,
                                 const T* __restrict__ P_base,
                                 float* __restrict__ CP, long long n_base,
                                 int rw, int nl) {
  extern __shared__ float smem[];
  float* Cs = smem;             // [NY][nl]
  float* CWt = smem + NY * nl;  // [NY][rw]
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const TC* Cb = C + b * NY * nl;
  const T* Wb = kFactor ? Wt + b * (long long)rw * nl : nullptr;
  for (int i = tid; i < NY * nl; i += blockDim.x) {
    Cs[i] = storage_round<T>(to_float<TC>(Cb[i]));
  }
  __syncthreads();

  if constexpr (kFactor) {
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
  }

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
    if constexpr (kFactor) {
      for (int r = 0; r < rw; ++r) {
        const float2 w = load_pair(Wb + (long long)r * nl + k);
#pragma unroll
        for (int i = 0; i < NY; ++i) {
          corr[i][0] = fmaf(CWt[i * rw + r], w.x, corr[i][0]);
          corr[i][1] = fmaf(CWt[i * rw + r], w.y, corr[i][1]);
        }
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

// P'[b] = P_src - round(Wt[b]^T Wt[b]) in the storage dtype   (K3)
// P_src = P_base[bidx[b]] with kGather, else 0 (bidx and P_base are never
// read); the product and the subtraction only with kDot (else Wt is never
// read and P' = P_src). Dynamic shared memory: kDot ? rw*nl floats : 0.
template <typename T, bool kGather, bool kDot>
__global__ void rebase_kernel(const int* __restrict__ bidx,
                              const T* __restrict__ Wt,
                              const T* __restrict__ P_base,
                              T* __restrict__ P_out, long long n_base, int rw,
                              int nl) {
  extern __shared__ float Ws[];  // [rw][nl], Wt[b] in f32
  const long long b = blockIdx.x;
  if constexpr (kDot) {
    const T* Wb = Wt + b * (long long)rw * nl;
    for (int i = threadIdx.x; i < rw * nl; i += blockDim.x) Ws[i] = to_float<T>(Wb[i]);
    __syncthreads();
  }

  bool ok = true;
  const T* Pb = nullptr;
  if constexpr (kGather) {
    const long long src = bidx[b];
    ok = src >= 0 && src < n_base;
    Pb = P_base + (ok ? src : 0) * (long long)nl * nl;
  }
  T* Ob = P_out + b * (long long)nl * nl;
  const int pairs = nl / 2;
  const int items = (nl / kItemRows) * pairs;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k = 2 * (item % pairs);
    const int j0 = (item / pairs) * kItemRows;
    float2 p[kItemRows];
#pragma unroll
    for (int rr = 0; rr < kItemRows; ++rr) {
      if constexpr (kGather) {
        p[rr] = ok ? load_pair(Pb + (long long)(j0 + rr) * nl + k)
                   : make_float2(quiet_nan(), quiet_nan());
      } else {
        p[rr] = make_float2(0.0f, 0.0f);
      }
    }
    if constexpr (kDot) {
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
        p[rr].x -= storage_round<T>(dd[rr][0]);
        p[rr].y -= storage_round<T>(dd[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kItemRows; ++rr) {
      store_pair(Ob + (long long)(j0 + rr) * nl + k, p[rr].x, p[rr].y);
    }
  }
}

}  // namespace
