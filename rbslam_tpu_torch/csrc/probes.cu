// Kernel-part probes for Hopper (sm_90a): the pieces of the Kalman update
// kernels K2, K3 and K5 as kernels of their own, so that a profile can say
// what holds each of those back (the gather, the products, or the write).
//
// K8 probe_gather_cp  replaces scripts/profile_gather_cp.py:_kernel_gcp
//     CP[b] = round_P(C[b]) P[bidx[b]], f32 sums; C f32, P never written.
//   K2 without the factor term: the same device code (gather_cp_kernel of
//   kf_common.cuh with kFactor = false), so K2's time minus K8's is the cost
//   of the factor term. Bound: N*nl*nl*itemsize gathered bytes of P.
//
// K9 probe_rebase_parts  replaces scripts/profile_rebase_parts.py:make_kernel
//     out[b] = P_src - round_P(Wt[b]^T Wt[b]), subtracted in P's dtype
//   with P_src = P[bidx[b]] if do_gather else 0, and the product only if
//   do_dot: gather + write, dot + write, both (K3's device code,
//   rebase_kernel of kf_common.cuh) and write only. Without the gather the
//   kernel reads nothing of P or bidx and still writes all N*nl*nl elements.
//   Bound: the bytes of the variant (write, plus the gathered read, plus Wt).
//   Design: with the product, K3's (bulk-copy ring, tensor cores at bf16);
//   without it the variant is a copy, so it runs K10's piece-major gather
//   (gather + write) or 16-byte stores of zeros (write only).
//
// K10 probe_gather  replaces scripts/profile_gather_kernel.py:_gather_kernel
//     out[b] = P[ai[b]], no arithmetic.
//   Bound: one read of each distinct matrix and one write of N*nl*nl*
//   itemsize. A copy of whole matrices (one block a matrix, 16-byte register
//   copies) already runs at the rate the memory gives a mixed read and
//   write stream; it loses where an index repeats far from its twin,
//   because the second read goes to memory again. Design
//   (gather_piece of kf_common.cuh, which K9 runs too): one warp per 2 KB
//   piece of one matrix, in by one asynchronous bulk copy (cp.async.bulk,
//   completion on an mbarrier) and out by another, walking piece-major (all
//   matrices' first piece, then all matrices' second, ...), so the pieces in
//   use at a time fit L2 and a repeated index hits it wherever it stands;
//   loads ask L2 to keep their lines, stores to drop theirs first. The
//   indices need not be sorted.
//
// K11 probe_block_products  replaces scripts/profile_block_mxu.py:_kernel
//     CP = C[b] P[b] (f32)   out[b] = round_P(P[b] - CP^T (0.7 CP))
//   K5's two products per particle without its gather and without the
//   innovation algebra (0.7 stands in for the gain), rounded once. The TPU
//   script's three formulations (vpu, batched, blockdiag) are one function;
//   it is computed once here. Bound: one read and one write of P. Design:
//   K5's: one block of 256 threads per particle, pass 1 streams P row by
//   row (thread = column pair x row slice) into partial CP sums, pass 2
//   writes row by row; P stays in shared memory between the passes where it
//   fits (nl=128), else pass 2 reads it again (nl=512 f32 is 1 MB).
//
// nl must be a multiple of 8; K9 and K10 need P, Wt and the output 16-byte
// aligned (bulk copies). All offsets are 64-bit. An index outside
// [0, n_base) writes NaN into that particle's output.

#include "kf_common.cuh"

namespace {

constexpr int kProbeThreads = 256;

template <typename T>
__global__ void __launch_bounds__(32)
gather_kernel(const int* __restrict__ ai, const T* __restrict__ P,
              T* __restrict__ out, long long n, long long n_all, int nl) {
  extern __shared__ __align__(128) unsigned char gather_stage[];
  __shared__ uint64_t full;
  gather_piece<T>(ai, P, out, n, n_all, nl, gather_stage, &full);
}

template <typename T, int NY>
__global__ void __launch_bounds__(kProbeThreads)
block_products_kernel(const float* __restrict__ C, const T* __restrict__ P,
                      T* __restrict__ out, int nl, int groups, int stash) {
  extern __shared__ float4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  T* Ps = reinterpret_cast<T*>(smem);  // [nl][nl] this particle's P, when stashed
  float* Cf = reinterpret_cast<float*>(
      smem + (stash ? (size_t)nl * nl * sizeof(T) : 0));  // [NY][nl]
  float* CP = Cf + NY * nl;            // [groups][NY][nl] partial sums; [0] = CP
  float* K = CP + groups * NY * nl;    // [NY][nl] 0.7 CP

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Cb = C + b * NY * nl;
  for (int i = tid; i < NY * nl; i += blockDim.x) Cf[i] = Cb[i];
  const T* Pb = P + b * (long long)nl * nl;
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
      const float2 p = load_pair(Pb + (long long)j * nl + k);
      if (stash) store_pair(Ps + j * nl + k, p.x, p.y);  // exact: p holds T values
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        acc[i][0] = fmaf(Cf[i * nl + j], p.x, acc[i][0]);
        acc[i][1] = fmaf(Cf[i * nl + j], p.y, acc[i][1]);
      }
    }
    float* part = CP + g * NY * nl;
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      part[i * nl + k] = acc[i][0];
      part[i * nl + k + 1] = acc[i][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NY * nl; idx += blockDim.x) {
    float v = CP[idx];
    for (int g = 1; g < groups; ++g) v += CP[g * NY * nl + idx];
    CP[idx] = v;
    K[idx] = 0.7f * v;
  }
  __syncthreads();

  // pass 2: out = round(P - CP^T K), row by row
  T* Ob = out + b * (long long)nl * nl;
#pragma unroll 4
  for (int item = tid; item < nl * pairs; item += blockDim.x) {
    const int r = item / pairs;
    const int k = 2 * (item % pairs);
    const float2 p = stash ? load_pair(Ps + r * nl + k)
                           : load_pair(Pb + (long long)r * nl + k);
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      const float c = CP[i * nl + r];
      const float2 kk = *reinterpret_cast<const float2*>(K + i * nl + k);
      d0 = fmaf(c, kk.x, d0);
      d1 = fmaf(c, kk.y, d1);
    }
    store_pair(Ob + (long long)r * nl + k, p.x - d0, p.y - d1);
  }
}

template <typename T, int NY>
cudaError_t launch_probe_gather_cp(const void* bidx, const void* C,
                                   const void* P, void* CP, long long n,
                                   long long n_base, int nl, cudaStream_t s) {
  int threads = ((nl / 2 + 31) / 32) * 32;  // one thread per column pair
  if (threads > 256) threads = 256;
  const size_t smem = (size_t)NY * nl * sizeof(float);
  cudaError_t err = allow_smem(gather_cp_kernel<T, float, NY, false>, smem);
  if (err != cudaSuccess) return err;
  gather_cp_kernel<T, float, NY, false><<<(unsigned)n, threads, smem, s>>>(
      static_cast<const int*>(bidx), static_cast<const float*>(C), nullptr,
      static_cast<const T*>(P), static_cast<float*>(CP), n_base, 0, nl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_probe_gather_cp_ny(int ny, const void* bidx, const void* C,
                                      const void* P, void* CP, long long n,
                                      long long n_base, int nl,
                                      cudaStream_t s) {
  switch (ny) {
    case 1: return launch_probe_gather_cp<T, 1>(bidx, C, P, CP, n, n_base, nl, s);
    case 2: return launch_probe_gather_cp<T, 2>(bidx, C, P, CP, n, n_base, nl, s);
    case 3: return launch_probe_gather_cp<T, 3>(bidx, C, P, CP, n, n_base, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_rebase_parts_flags(int do_gather, int do_dot,
                                      const void* bidx, const void* Wt,
                                      const void* P, void* out, long long n,
                                      long long n_base, int rw, int nl,
                                      cudaStream_t s) {
  if (do_gather) {
    return do_dot ? launch_rebase_kernel<T, true, true>(bidx, Wt, P, out, n, n_base, rw, nl, s)
                  : launch_rebase_kernel<T, true, false>(bidx, Wt, P, out, n, n_base, rw, nl, s);
  }
  return do_dot ? launch_rebase_kernel<T, false, true>(bidx, Wt, P, out, n, n_base, rw, nl, s)
                : launch_rebase_kernel<T, false, false>(bidx, Wt, P, out, n, n_base, rw, nl, s);
}

template <typename T>
cudaError_t launch_gather(const void* ai, const void* P, void* out,
                          long long n, long long n_all, int nl,
                          cudaStream_t s) {
  const long long blocks = n * gather_pieces(nl, sizeof(T));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_kernel<T><<<(unsigned)blocks, 32, kGatherPiece, s>>>(
      static_cast<const int*>(ai), static_cast<const T*>(P),
      static_cast<T*>(out), n, n_all, nl);
  return cudaGetLastError();
}

template <typename T, int NY>
cudaError_t launch_block_products(const void* C, const void* P, void* out,
                                  long long n, int nl, cudaStream_t s) {
  int groups = kProbeThreads / (nl / 2);
  if (groups < 1) groups = 1;
  const size_t fbytes = (size_t)NY * nl * (2 + groups) * sizeof(float);
  const size_t pbytes = (size_t)nl * nl * sizeof(T);
  const int stash = fbytes + pbytes <= kStashBytes;
  const size_t smem = fbytes + (stash ? pbytes : 0);
  cudaError_t err = allow_smem(block_products_kernel<T, NY>, smem);
  if (err != cudaSuccess) return err;
  block_products_kernel<T, NY><<<(unsigned)n, kProbeThreads, smem, s>>>(
      static_cast<const float*>(C), static_cast<const T*>(P),
      static_cast<T*>(out), nl, groups, stash);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block_products_ny(int ny, const void* C, const void* P,
                                     void* out, long long n, int nl,
                                     cudaStream_t s) {
  switch (ny) {
    case 1: return launch_block_products<T, 1>(C, P, out, n, nl, s);
    case 2: return launch_block_products<T, 2>(C, P, out, n, nl, s);
    case 3: return launch_block_products<T, 3>(C, P, out, n, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbs_probe_gather_cp(const void* bidx, const void* C,
                                   const void* P, void* CP, long long n,
                                   long long n_base, int ny, int nl, int bf16,
                                   void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_probe_gather_cp_ny<__nv_bfloat16>(ny, bidx, C, P, CP, n, n_base, nl, s)
           : launch_probe_gather_cp_ny<float>(ny, bidx, C, P, CP, n, n_base, nl, s);
  return (int)err;
}

extern "C" int rbs_probe_rebase_parts(const void* bidx, const void* Wt,
                                      const void* P, void* out, long long n,
                                      long long n_base, int rw, int nl,
                                      int do_gather, int do_dot, int bf16,
                                      void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_rebase_parts_flags<__nv_bfloat16>(do_gather, do_dot, bidx, Wt, P, out, n, n_base, rw, nl, s)
           : launch_rebase_parts_flags<float>(do_gather, do_dot, bidx, Wt, P, out, n, n_base, rw, nl, s);
  return (int)err;
}

extern "C" int rbs_probe_gather(const void* ai, const void* P, void* out,
                                long long n, long long n_all, int nl, int bf16,
                                void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_gather<__nv_bfloat16>(ai, P, out, n, n_all, nl, s)
           : launch_gather<float>(ai, P, out, n, n_all, nl, s);
  return (int)err;
}

extern "C" int rbs_probe_block_products(const void* C, const void* P, void* out,
                                        long long n, int ny, int nl, int bf16,
                                        void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_block_products_ny<__nv_bfloat16>(ny, C, P, out, n, nl, s)
           : launch_block_products_ny<float>(ny, C, P, out, n, nl, s);
  return (int)err;
}
