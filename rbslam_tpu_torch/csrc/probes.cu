// Kernel-part probes for Hopper (sm_90a): the pieces of the Kalman update
// kernels K2, K3 and K5 as kernels of their own, so that a profile can say
// what holds each of those back (the gather, the products, or the write).
//
// K8 probe_gather_cp  replaces scripts/profile_gather_cp.py:_kernel_gcp
//     CP[b] = round_P(C[b]) P[bidx[b]], f32 sums; C f32, P never written.
//   K2 without the factor term: the same device code with kFactor = false,
//   in K2's form for the dtype and width (kf_common.cuh: gather_cp_kernel,
//   the bulk-copy ring of pieces of runs and the row-split pass, at f32;
//   gather_cp_runs_kernel at bf16: each one read of P a run of equal
//   indices), so
//   K2's time minus K8's is the cost of the factor term. Bound: one read of
//   each distinct P a tile meets (N*nl*nl*itemsize at most), C, and CP.
//
// K9 probe_rebase_parts  replaces scripts/profile_rebase_parts.py:make_kernel
//     out[b] = P_src - round_P(Wt[b]^T Wt[b]), subtracted in P's dtype
//   with P_src = P[bidx[b]] if do_gather else 0, and the product only if
//   do_dot: gather + write, dot + write, both (K3's device code,
//   rebase_kernel of kf_common.cuh, or rebase_wide_kernel where its ring and
//   factor do not fit) and write only. Without the gather the kernel reads
//   nothing of P or bidx and still writes all N*nl*nl elements.
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
//   K5's device code (kf_block.cuh with kUpdate = false) in K5's form for
//   the width: P resident in the block's shared memory by bulk copies, read
//   from memory once (nl=128), else streamed or in two passes. So K5 minus
//   K11 is the gather plus the innovation algebra.
//
// nl must be a multiple of 8; the tensors a bulk copy touches must be
// 16-byte aligned (the wrappers copy a view that is not). All offsets are
// 64-bit. An index outside [0, n_base) writes NaN into that particle's
// output.

#include "kf_block.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(32)
gather_kernel(const int* __restrict__ ai, const T* __restrict__ P,
              T* __restrict__ out, long long n, long long n_all, int nl) {
  extern __shared__ __align__(128) unsigned char gather_stage[];
  __shared__ uint64_t full;
  gather_piece<T>(ai, P, out, n, n_all, nl, gather_stage, &full);
}

template <typename T>
cudaError_t launch_probe_gather_cp_ny(int ny, const void* bidx, const void* C,
                                      const void* P, void* CP, long long n,
                                      long long n_base, int nl, int plan,
                                      cudaStream_t s) {
  switch (ny) {
    case 1: return launch_gather_cp_kernel<T, float, 1, false>(bidx, C, nullptr, P, CP, n, n_base, 0, 0, nl, plan, 0, nullptr, s);
    case 2: return launch_gather_cp_kernel<T, float, 2, false>(bidx, C, nullptr, P, CP, n, n_base, 0, 0, nl, plan, 0, nullptr, s);
    case 3: return launch_gather_cp_kernel<T, float, 3, false>(bidx, C, nullptr, P, CP, n, n_base, 0, 0, nl, plan, 0, nullptr, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_rebase_parts_flags(int do_gather, int do_dot,
                                      const void* bidx, const void* Wt,
                                      const void* P, void* out, long long n,
                                      long long n_base, int rw, int nl,
                                      int variant, cudaStream_t s) {
  if (do_gather) {
    return do_dot ? launch_rebase_kernel<T, true, true>(bidx, Wt, P, out, n, n_base, rw, nl, variant, s)
                  : launch_rebase_kernel<T, true, false>(bidx, Wt, P, out, n, n_base, rw, nl, variant, s);
  }
  return do_dot ? launch_rebase_kernel<T, false, true>(bidx, Wt, P, out, n, n_base, rw, nl, variant, s)
                : launch_rebase_kernel<T, false, false>(bidx, Wt, P, out, n, n_base, rw, nl, variant, s);
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

template <typename T>
cudaError_t launch_block_products_ny(int ny, const void* C, const void* P,
                                     void* out, long long n, int nl, int plan,
                                     cudaStream_t s) {
  constexpr float kGain = 0.7f;
  switch (ny) {
    case 1: return launch_block_kernel<T, 1, false>(nullptr, C, nullptr, nullptr, P, nullptr, out, nullptr, nullptr, nullptr, n, n, nl, plan, 0.0f, kGain, s);
    case 2: return launch_block_kernel<T, 2, false>(nullptr, C, nullptr, nullptr, P, nullptr, out, nullptr, nullptr, nullptr, n, n, nl, plan, 0.0f, kGain, s);
    case 3: return launch_block_kernel<T, 3, false>(nullptr, C, nullptr, nullptr, P, nullptr, out, nullptr, nullptr, nullptr, n, n, nl, plan, 0.0f, kGain, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbs_probe_gather_cp(const void* bidx, const void* C,
                                   const void* P, void* CP, long long n,
                                   long long n_base, int ny, int nl, int plan,
                                   int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_probe_gather_cp_ny<__nv_bfloat16>(ny, bidx, C, P, CP, n, n_base, nl, plan, s)
           : launch_probe_gather_cp_ny<float>(ny, bidx, C, P, CP, n, n_base, nl, plan, s);
  return (int)err;
}

extern "C" int rbs_probe_rebase_parts(const void* bidx, const void* Wt,
                                      const void* P, void* out, long long n,
                                      long long n_base, int rw, int nl,
                                      int do_gather, int do_dot, int variant,
                                      int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_rebase_parts_flags<__nv_bfloat16>(do_gather, do_dot, bidx, Wt, P, out, n, n_base, rw, nl, variant, s)
           : launch_rebase_parts_flags<float>(do_gather, do_dot, bidx, Wt, P, out, n, n_base, rw, nl, variant, s);
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
                                        long long n, int ny, int nl, int plan,
                                        int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_block_products_ny<__nv_bfloat16>(ny, C, P, out, n, nl, plan, s)
           : launch_block_products_ny<float>(ny, C, P, out, n, nl, plan, s);
  return (int)err;
}
