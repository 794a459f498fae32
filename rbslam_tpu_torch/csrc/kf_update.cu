// Kalman update kernels for Hopper (sm_90a): the gathered dense update (K5)
// and the factored-covariance update (K2, K3). The device code lives in
// kf_block.cuh (K5, shared with the probe K11) and kf_common.cuh (K2 and K3,
// shared with the probes K8 and K9); this file holds their C entry points.
//
// K5 block_gather  replaces rbslam_tpu/kernels/kf_update.py:_kernel_block_gather
//   (its math is _block_update_math, its repair _spd_inv_logdet): the whole
//   dense KF update of each particle on its ancestor's covariance P_all[ai[b]]
//   (see kf_block.cuh for the formulas and the rounding points).
//   Bound: one gathered read plus one write of P per step,
//   2*N*nl*nl*itemsize bytes: 1.07 GB at N=16384, nl=128, bf16 (>= 0.32 ms
//   at 3.35 TB/s); 8.6 GB at N=4096, nl=512, f32. The products are rank
//   ny <= 3 and hide under the bytes on the CUDA cores, so the task is to
//   keep bytes in flight and read P once. Design (kf_block.cuh): where P fits
//   one block (nl=128), P comes into shared memory by bulk copies on staged
//   mbarriers, C P starts on the first stage, several particles share an SM
//   so one's algebra overlaps another's copies, and P' is formed from the
//   resident P; wider P is read twice, streamed 16 bytes a thread with the
//   second read meant for L2 (bf16), or in the two-pass form (f32, where it
//   measured faster than the streamed form and than clusters of blocks
//   holding row slabs).
//
// The filter carries each particle's covariance as P = P_base[bidx] - Wt^T Wt
// (P_base read-only between rebases, Wt [rw, nl] the accumulated factor rows).
//
// K2 gather_cp  replaces rbslam_tpu/kernels/kf_update.py:_kernel_gather_cp
//     CP[b] = C[b] P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]     -> [N, ny, nl] f32
//   with only the first `rows` (live) factor rows of Wt[b] read.
//   Bound: the bytes, each distinct ancestor matrix of P_base read once
//   (at most N*nl*nl*itemsize a step: 0.54 GB at N=16384, nl=128, bf16),
//   C and the live rows of Wt read once, CP written once. Design at bf16
//   (gather_cp_runs_kernel of kf_common.cuh): the direct form's small
//   blocks (one thread a column pair of P, streamed from global memory),
//   each on two consecutive particles: a run of equal base indices (the
//   main path's come side by side) streams its P once for both; the live
//   factor rows are staged in shared memory once by cp.async while P
//   streams, and round(C Wt^T) and the correction are formed from there.
//   Design at f32
//   (gather_cp_kernel of kf_common.cuh): the particles fall into pieces,
//   runs of equal valid base indices cut every four particles; persistent
//   blocks take equal shares of the pieces in order (each block counts the
//   pieces of bidx itself); a producer warp bulk-copies a piece's C, then
//   streams the piece's P_base matrix once and each particle's live factor
//   rows, in row stages through a four-stage ring that runs on across
//   pieces; eight consumer warps take each stage of P once for every
//   particle of the piece (16-byte shared loads, partial sums per row group
//   summed in a fixed order), write C P out, then form -round(C Wt^T) of
//   each staged factor row and add the correction, summed apart. While a
//   span recorder runs (utils/profiling.py) the f32 form adds the number
//   of matrices it read to a device counter. No gathered copy of
//   P_base is ever written to device memory. For rows of more than 256
//   16-byte units at f32, or more than 512 columns at bf16, the direct form
//   runs (each thread streams a column pair of P from global memory).
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
//   store 16 bytes a thread. Where the ring and the staged factor do not fit
//   shared memory (nl = 2048), rebase_wide_kernel reads Wt through L1 and P
//   through registers. The output is a new tensor: several particles
//   read the same ancestor row of P_base, so it can never be updated in
//   place.
//
// nl must be a multiple of 8 (the engine pads it to a multiple of 128);
// the tensors a bulk copy reads or writes must be 16-byte aligned (the
// wrappers copy a view that is not). Each entry takes the form the wrapper
// chose (`plan`, `variant`) and refuses a launch where its own planner
// chooses another, so the wrapper's mirror of the planner cannot drift.
// All offsets are 64-bit (N*nl*nl exceeds 2^31 at 131k particles). An
// ancestor or base index outside [0, n_base) writes NaN into that
// particle's output instead of reading out of bounds, so a bad index shows
// up in the weights.

#include "kf_block.cuh"

namespace {

template <typename T>
cudaError_t launch_gather_cp_ny(int ny, const void* bidx, const void* C,
                                const void* Wt, const void* P_base, void* CP,
                                long long n, long long n_base, int rw, int rows,
                                int nl, int plan, int direct, void* reads,
                                cudaStream_t s) {
  switch (ny) {
    case 1: return launch_gather_cp_kernel<T, T, 1, true>(bidx, C, Wt, P_base, CP, n, n_base, rw, rows, nl, plan, direct, reads, s);
    case 2: return launch_gather_cp_kernel<T, T, 2, true>(bidx, C, Wt, P_base, CP, n, n_base, rw, rows, nl, plan, direct, reads, s);
    case 3: return launch_gather_cp_kernel<T, T, 3, true>(bidx, C, Wt, P_base, CP, n, n_base, rw, rows, nl, plan, direct, reads, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_block_gather_ny(int ny, const void* ai, const void* C,
                                   const void* e, const void* xl,
                                   const void* P_all, const void* R,
                                   void* P_out, void* xl_out, void* logw,
                                   void* bad, long long n, long long n_all,
                                   int nl, int plan, float jitter,
                                   cudaStream_t s) {
  switch (ny) {
    case 1: return launch_block_kernel<T, 1, true>(ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, plan, jitter, 0.0f, s);
    case 2: return launch_block_kernel<T, 2, true>(ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, plan, jitter, 0.0f, s);
    case 3: return launch_block_kernel<T, 3, true>(ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, plan, jitter, 0.0f, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbs_block_gather(const void* ai, const void* C, const void* e,
                                const void* xl, const void* P_all,
                                const void* R, void* P_out, void* xl_out,
                                void* logw, void* bad, long long n,
                                long long n_all, int ny, int nl, float jitter,
                                int plan, int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_block_gather_ny<__nv_bfloat16>(ny, ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, plan, jitter, s)
           : launch_block_gather_ny<float>(ny, ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, nl, plan, jitter, s);
  return (int)err;
}

extern "C" int rbs_gather_cp(const void* bidx, const void* C, const void* Wt,
                             const void* P_base, void* CP, long long n,
                             long long n_base, int ny, int rw, int rows,
                             int nl, int plan, int direct, int bf16,
                             void* reads, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_gather_cp_ny<__nv_bfloat16>(ny, bidx, C, Wt, P_base, CP, n, n_base, rw, rows, nl, plan, direct, reads, s)
           : launch_gather_cp_ny<float>(ny, bidx, C, Wt, P_base, CP, n, n_base, rw, rows, nl, plan, direct, reads, s);
  return (int)err;
}

extern "C" int rbs_rebase(const void* bidx, const void* Wt, const void* P_base,
                          void* P_out, long long n, long long n_base, int rw,
                          int nl, int variant, int bf16, void* stream) {
  if (nl % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_rebase_kernel<__nv_bfloat16, true, true>(bidx, Wt, P_base, P_out, n, n_base, rw, nl, variant, s)
           : launch_rebase_kernel<float, true, true>(bidx, Wt, P_base, P_out, n, n_base, rw, nl, variant, s);
  return (int)err;
}
