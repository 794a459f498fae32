// Device code shared by the Kalman update kernels (kf_update.cu) and the
// kernel-part probes (probes.cu): storage-dtype helpers, the row-split pass
// C P over rows of P in shared memory (K2, K8, and K5, K11 in kf_block.cuh),
// the gathered CP contraction (K2, and K8 with the factor term compiled
// out), the gather by asynchronous bulk copies (K10, and inside K9) and the
// rebase (K3, and K9 with its gather and its product switched separately).
// Each translation unit instantiates its own copies (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

inline __host__ __device__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// shared memory one block may use on Hopper
constexpr size_t kMaxSmem = 232448;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  // static shared memory (barriers, small tables) counts against the 48 KB
  // a kernel may use without asking
  if (smem + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Blocks of a persistent kernel: as many as the card holds at once, at most n.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                              long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long all = (long long)sms * per_sm;
  *blocks = (int)(n < all ? n : all);
  return cudaSuccess;
}

// The direct form of K2 (and K8), for map widths the staged form below
// does not take (more than 256 16-byte units a row, or a ring and C that do
// not fit shared memory): CP[b] = round_T(C[b]) P_base[bidx[b]] -
// round(C[b] Wt[b]^T) Wt[b], each thread on a column pair streaming every
// row of P from global memory, Wt read from global memory twice. Only the
// first `rows` factor rows of each particle are read (the others are zero).
// C is read as TC and rounded to T (the identity where TC = T); with
// kFactor false the factor term is compiled out and Wt is never read (K8).
// Dynamic shared memory: (NY*nl + (kFactor ? NY*rw : 0)) floats.
template <typename T, typename TC, int NY, bool kFactor>
__global__ void gather_cp_direct_kernel(const int* __restrict__ bidx,
                                 const TC* __restrict__ C,
                                 const T* __restrict__ Wt,
                                 const T* __restrict__ P_base,
                                 float* __restrict__ CP, long long n_base,
                                 int rw, int rows, int nl) {
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
    for (int r = warp; r < rows; r += nwarps) {
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
      for (int r = 0; r < rows; ++r) {
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

// ---- asynchronous bulk copies (TMA's 1-D form) and their barriers --------
// A bulk copy moves a contiguous run of bytes (16-byte aligned address and
// size) between global and shared memory without passing through registers;
// one thread starts it. A load reports its bytes to an mbarrier in shared
// memory; stores are tracked in per-thread groups.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst_smem)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// wait until all but the newest kPending store groups of this thread have
// read their shared memory
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}
// ---- the gather: out[b] = P[idx[b]] by bulk copies ----------------------
// Bound: one read of every distinct matrix and one write of every matrix,
// no arithmetic. A copy of whole matrices already runs at the rate the
// memory gives a mixed read and write stream; what is left to win is the
// reads of duplicate indices, which must come from L2 and not from memory
// again. Design: one warp per piece of kGatherPiece bytes of one matrix;
// lane 0 brings the piece into shared memory by one asynchronous bulk copy
// and sends it out by another (no thread spends registers on the copy; the
// blocks of an SM overlap each other's loads and stores). The grid walks
// piece-major: all matrices' piece 0, then all matrices' piece 1, ..., so
// the reads of the moment are n pieces (32 MB at n=16384, 8 MB at n=4096),
// which L2 holds, and a duplicate index hits L2 wherever it stands in the
// index vector: the indices need not be sorted. Loads ask
// L2 to keep their lines (evict_last), stores to drop theirs first
// (evict_first). An index outside [0, n_src) starts no load: the lanes
// write NaN.
constexpr uint32_t kGatherPiece = 2048;

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ void bulk_load_hint(void* dst_smem, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst_smem)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_store_hint(void* dst, const void* src_smem,
                                                uint32_t bytes,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;" ::"l"(dst),
      "r"(smem_u32(src_smem)), "r"(bytes), "l"(policy)
      : "memory");
}

inline long long gather_pieces(int nl, size_t itemsize) {   // per matrix
  return ((long long)nl * nl * itemsize + kGatherPiece - 1) / kGatherPiece;
}

// The piece blockIdx.x of out[b] = P[idx[b]]; one warp.
// stage: kGatherPiece bytes of shared memory; full: one barrier.
template <typename T>
__device__ void gather_piece(const int* __restrict__ idx,
                             const T* __restrict__ P, T* __restrict__ out,
                             long long n, long long n_src, int nl,
                             unsigned char* stage, uint64_t* full) {
  const int lane = threadIdx.x & 31;
  const long long mat = (long long)nl * nl * sizeof(T);
  const long long b = blockIdx.x % n;
  const long long off = (blockIdx.x / n) * kGatherPiece;
  const uint32_t bytes = (uint32_t)min((long long)kGatherPiece, mat - off);
  const long long src = idx[b];
  unsigned char* dst = reinterpret_cast<unsigned char*>(out) + b * mat + off;
  if (src < 0 || src >= n_src) {
    const uint32_t w = sizeof(T) == 4 ? 0x7fc00000u : 0x7fc07fc0u;
    for (uint32_t i = lane; i < bytes / 16; i += 32) {
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(w, w, w, w);
    }
    return;
  }
  if (lane != 0) return;
  const unsigned char* from =
      reinterpret_cast<const unsigned char*>(P) + src * mat + off;
  mbar_init(full, 1);
  mbar_init_fence();
  mbar_arrive_expect_tx(full, bytes);
  bulk_load_hint(stage, from, bytes, full, policy_evict_last());
  mbar_wait(full, 0);
  bulk_store_hint(dst, stage, bytes, policy_evict_first());
  bulk_commit();
  bulk_wait_read<0>();
}

// out = 0 (write only): the output is one run of n*nl*nl elements; a block
// of kZeroThreads threads stores kZeroBytes of it, 16 bytes a thread at a time.
constexpr int kZeroThreads = 256;
constexpr long long kZeroBytes = 16384;

template <typename T>
__device__ void zero_run(T* __restrict__ out, long long n, int nl) {
  const long long total = n * nl * nl * (long long)sizeof(T);
  const long long off = blockIdx.x * kZeroBytes;
  const int units = (int)(min(kZeroBytes, total - off) / 16);
  uint4* dst = reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(out) + off);
  for (int i = threadIdx.x; i < units; i += kZeroThreads) {
    dst[i] = make_uint4(0, 0, 0, 0);
  }
}

// ---- 16-byte units, and the row-split pass C P (K2, K8, K5, K11) --------
// A pass over the rows of a matrix P [nl, nl] held in shared memory: a
// thread owns one 16-byte unit of columns (4 f32 or 8 bf16 values) and the
// rows j = g, g + groups, ... of its group g, so a warp reads whole 16-byte
// units of neighbouring columns (no bank conflicts) and each thread keeps
// NY x 4 or NY x 8 partial sums in registers. The partial sums of the
// groups meet in shared memory, one set per warp where a warp holds whole
// groups (a unit count that divides 32: summed first by shuffles), else one
// set per group; the sets are summed in one fixed order, so two runs give
// the same bits.

template <typename T>
struct Unit {
  static constexpr int kElems = 16 / sizeof(T);
};

__device__ __forceinline__ void unit_values(uint4 x, float (&v)[4]) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unit_values(uint4 x, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
// 16 bytes of T at p (shared or global memory) as floats
template <typename T>
__device__ __forceinline__ void load_unit(const T* p, float (&v)[16 / sizeof(T)]) {
  unit_values(*reinterpret_cast<const uint4*>(p), v);
}
// the same from global memory, asking L2 to keep the line (it is read again)
template <typename T>
__device__ __forceinline__ void load_unit_keep(const T* p, float (&v)[16 / sizeof(T)],
                                               uint64_t policy) {
  uint4 x;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
      : "l"(p), "l"(policy));
  unit_values(x, v);
}
// the same, the last read of the line (L2 may drop it first)
template <typename T>
__device__ __forceinline__ void load_unit_last(const T* p, float (&v)[16 / sizeof(T)]) {
  unit_values(__ldcs(reinterpret_cast<const uint4*>(p)), v);
}
// 16 bytes to global memory as a streaming store (L2 drops the lines first)
__device__ __forceinline__ void store_unit_stream(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_unit_stream(__nv_bfloat16* p,
                                                  const float (&v)[8]) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  __stcs(reinterpret_cast<uint4*>(p), x);
}

constexpr int kRowThreads = 256;   // the threads of a row-split pass

inline __host__ __device__ int row_units(int nl, int itemsize) {
  return nl * itemsize / 16;
}
inline __host__ __device__ int row_groups(int units) {
  return units >= kRowThreads ? 1 : kRowThreads / units;
}
inline __host__ __device__ bool row_shfl(int units) {
  return units < 32 && 32 % units == 0;
}
// sets of partial sums in shared memory
inline __host__ __device__ int row_sets(int units) {
  return row_shfl(units) ? kRowThreads / 32 : row_groups(units);
}

// A thread's place in the pass (units <= kRowThreads: the planners see to it).
struct RowSplit {
  int units, groups, u, g, set;
  bool active, shfl;
  __device__ RowSplit(int nl, int itemsize, int tid) {
    units = row_units(nl, itemsize);
    groups = row_groups(units);
    shfl = row_shfl(units);
    u = tid % units;
    g = tid / units;
    active = g < groups;
    set = shfl ? tid / 32 : g;
  }
};

// acc[i][e] += Cr[i][j] P[j][unit u, element e] over this thread's rows j of
// [j0, j1); `rows` holds row j0 of P [., nl], Cr is [NY][ldc]. kKeep: the
// rows lie in global memory and are read again soon (L2 keeps them).
template <typename T, int NY, bool kKeep = false>
__device__ __forceinline__ void cp_rows(const T* rows, int j0, int j1, int nl,
                                        const RowSplit& rs, const float* Cr,
                                        int ldc,
                                        float (&acc)[NY][Unit<T>::kElems]) {
  constexpr int E = Unit<T>::kElems;
  if (!rs.active) return;
  uint64_t policy = 0;
  if constexpr (kKeep) policy = policy_evict_last();
#pragma unroll 4
  for (int j = j0 + ((rs.g - j0) % rs.groups + rs.groups) % rs.groups; j < j1;
       j += rs.groups) {
    float p[E];
    if constexpr (kKeep) {
      load_unit_keep(rows + (size_t)(j - j0) * nl + rs.u * E, p, policy);
    } else {
      load_unit(rows + (size_t)(j - j0) * nl + rs.u * E, p);
    }
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      const float c = Cr[i * ldc + j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = fmaf(c, p[e], acc[i][e]);
    }
  }
}

// This thread's partial sums into its set of part [sets][NY][nl]; every
// thread of the pass calls it (the shuffles need whole warps).
template <int NY, int E>
__device__ __forceinline__ void cp_partial_store(float (&acc)[NY][E],
                                                 const RowSplit& rs,
                                                 float* part, int nl, int lane) {
  if (rs.shfl) {
    for (int off = rs.units; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < NY; ++i) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        }
      }
    }
    if (lane >= rs.units) return;
  } else if (!rs.active) {
    return;
  }
  float* dst = part + (size_t)rs.set * NY * nl + rs.u * E;
#pragma unroll
  for (int i = 0; i < NY; ++i) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      *reinterpret_cast<float4*>(dst + i * nl + e) =
          make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
    }
  }
}

// entry idx of the summed sets, in set order
template <int NY>
__device__ __forceinline__ float cp_partial_sum(const float* part, int sets,
                                                int nl, int idx) {
  float v = part[idx];
  for (int s = 1; s < sets; ++s) v += part[(size_t)s * NY * nl + idx];
  return v;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kRowThreads) : "memory");
}

// ---- the gathered C P with the factor term (K2; K8 without it) -----------
// CP[b] = round_T(C[b]) P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]
// with only the first `live` factor rows of Wt[b] read (the others are
// zero). The float32 form, where round_T is the identity.
// Bound: the bytes, each P_base matrix read once a run of equal base
// indices (on the filter's main path the base indices are arange composed
// with sorted systematic ancestors, so equal ones stand side by side), C
// and the live rows of Wt read once, CP written once; the products, 2 ny nl
// (nl + 2 live) flops a particle, hide under the bytes on the CUDA cores.
// Design: the particles fall into pieces, each a run of equal valid base
// indices cut every kCpRun particles from the run's start (an index outside
// [0, n_base) is a piece of its own and reads nothing). Persistent blocks,
// each with a producer warp and eight consumer warps, take equal shares of
// the pieces in order: every block counts the pieces of all of bidx (a
// scan over the consumer threads' chunks: no helper kernel, no atomics)
// and walks its own contiguous share. For each piece the producer
// bulk-copies the piece's C into one of two buffers, then streams through
// a ring of kCpStages stages of whole rows (about 8 KB), on full / empty
// mbarriers, P_base[bidx[b]] once and then each particle's live factor
// rows; the ring runs on across pieces, so no consumer waits on a global
// load. Each consumer thread keeps, for every particle of the piece, the
// partial sums of its 16-byte unit of columns over its row group (the
// row-split pass) and takes each staged row of P once for all of them;
// the sums of the sets go out in a fixed order. Then each staged factor row
// gets its coefficient -round(C Wt^T) (a warp a row, lanes over the
// columns) and enters a particle's correction, summed by the same split in
// 12 registers of its own and added to the output: no sums of P stay live
// through it, which kept the pass free of register spills. At 4 particles
// a piece (48 sums a thread) the pass keeps pace with the memory; at 5 it
// fell behind on the H100. At nl = 640 a block takes 92 KB and two share
// an SM.
constexpr int kCpRun = 4;         // particles a piece: 4 x NY x 4 sums a thread
constexpr int kCpStages = 4;
constexpr int kCpStageBytes = 8192;
constexpr int kCpThreads = kRowThreads + 32;   // consumers and the producer
constexpr size_t kSmemBudget = kMaxSmem - 1024;   // room for static barriers
enum : int { kCpRunsF32 = 0, kCpDirect = 2, kCpRuns = 3 };

inline __host__ __device__ int cp_stage_rows(int nl, int itemsize) {
  int rows = kCpStageBytes / (nl * itemsize);
  if (rows < 1) rows = 1;
  return rows < nl ? rows : nl;
}

// sets of partial sums that K2's float32 form sums through shared memory:
// none where each thread holds whole sums of its own columns
inline __host__ __device__ int cp_part_sets(int nl) {
  const int units = row_units(nl, 4);
  return row_sets(units) == 1 && !row_shfl(units) ? 0 : row_sets(units);
}

// the ring, two buffers of a piece's C [kCpRun][NY][nl], the sets of
// partial sums of one particle, its -round(C Wt^T) [NY][rw]
inline size_t gather_cp_smem(int ny, int rw, int nl, bool factor) {
  return (size_t)kCpStages * cp_stage_rows(nl, 4) * nl * 4 +
         4 * (size_t)ny * nl * (2 * kCpRun + cp_part_sets(nl)) +
         (factor ? 4 * (size_t)ny * rw : 0);
}

// the piece that starts at particle b: its particles (1 to kCpRun) and its
// base index (-1 where out of range)
__device__ __forceinline__ int piece_at(const int* __restrict__ bidx,
                                        long long b, long long n,
                                        long long n_base, long long* src) {
  const int s = bidx[b];
  const bool ok = s >= 0 && s < n_base;
  int len = 1;
  if (ok) {
    while (len < kCpRun && b + len < n && bidx[b + len] == s) ++len;
  }
  *src = ok ? s : -1;
  return len;
}

// An exclusive scan over the kRowThreads consumer threads (a sum, or with
// kMax a maximum with -1 for nothing); *tot gets the whole reduction.
// scratch: kRowThreads / 32 values.
template <bool kMax>
__device__ long long consumer_scan(long long v, long long* scratch,
                                   long long* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long none = kMax ? -1 : 0;
  long long inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = kMax ? max(inc, y) : inc + y;
  }
  const long long up = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 31) scratch[warp] = inc;
  consumer_sync();
  long long before = none, all = none;
  for (int w = 0; w < kRowThreads / 32; ++w) {
    const long long x = scratch[w];
    if (w < warp) before = kMax ? max(before, x) : before + x;
    all = kMax ? max(all, x) : all + x;
  }
  consumer_sync();   // scratch is written again by the next scan
  *tot = all;
  const long long in_warp = lane == 0 ? none : up;
  return kMax ? max(before, in_warp) : before + in_warp;
}

// particles of [a, b) a multiple of kCpRun after the run start r <= a
__device__ __forceinline__ long long cuts_in(long long a, long long b,
                                             long long r) {
  if (b <= a) return 0;
  const long long lo = a - 1 - r >= 0 ? (a - 1 - r) / kCpRun : -1;
  return (b - 1 - r) / kCpRun - lo;
}

// This block's share of the pieces, by the consumer threads: its first
// particle into *first and its number of pieces into *count. Each thread
// takes a chunk of bidx; a particle starts a run where its index differs
// from its predecessor's or is out of range.
__device__ void block_pieces(const int* __restrict__ bidx, long long n,
                             long long n_base, long long* scratch,
                             long long* first, long long* count) {
  const int tid = threadIdx.x;
  const long long ch = (n + kRowThreads - 1) / kRowThreads;
  const long long lo = min(n, tid * ch), hi = min(n, lo + ch);
  // the last run start of the chunk, and the pieces from its first on
  long long first_rs = -1, rs = -1, mine = 0;
  int prev = lo > 0 ? bidx[lo - 1] : -1;
#pragma unroll 8
  for (long long i = lo; i < hi; ++i) {
    const int s = bidx[i];
    if (i == 0 || s != prev || s < 0 || s >= n_base) {
      rs = i;
      if (first_rs < 0) first_rs = i;
    }
    prev = s;
    if (rs >= 0 && (i - rs) % kCpRun == 0) ++mine;
  }
  long long unused;
  // the run in course at the chunk's start (begun in an earlier chunk)
  const long long carry = consumer_scan<true>(rs, scratch, &unused);
  if (carry >= 0) mine += cuts_in(lo, first_rs >= 0 ? first_rs : hi, carry);
  long long total;
  const long long before = consumer_scan<false>(mine, scratch, &total);
  const long long p_lo = (long long)blockIdx.x * total / gridDim.x;
  const long long p_hi = ((long long)blockIdx.x + 1) * total / gridDim.x;
  if (tid == 0) *count = p_hi - p_lo;
  if (p_lo < p_hi && before <= p_lo && p_lo < before + mine) {
    long long p = before, r = carry;
    prev = lo > 0 ? bidx[lo - 1] : -1;
    for (long long i = lo; i < hi; ++i) {
      const int s = bidx[i];
      if (i == 0 || s != prev || s < 0 || s >= n_base) r = i;
      prev = s;
      if ((i - r) % kCpRun == 0) {
        if (p == p_lo) {
          *first = i;
          break;
        }
        ++p;
      }
    }
  }
}

// acc[l][i][e] += Cr[l][i][j] P[j][unit u, element e] for the L particles of
// a piece over this thread's rows of [j0, j1): a row read once for all of
// them; `rows` holds row j0 of the staged P, Cr is [kCpRun][NY][nl]; jn is
// the thread's next row (its group's rows g, g + groups, ... in order).
template <int NY, int L>
__device__ __forceinline__ void cp_rows_piece(const float* rows, int j0, int j1,
                                              int& jn, int nl,
                                              const RowSplit& rs, const float* Cr,
                                              float (&acc)[kCpRun][NY][4]) {
#pragma unroll 2
  for (; jn < j1; jn += rs.groups) {
    float p[4];
    load_unit(rows + (size_t)(jn - j0) * nl + rs.u * 4, p);
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        const float c = Cr[(l * NY + i) * nl + jn];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[l][i][e] = fmaf(c, p[e], acc[l][i][e]);
      }
    }
  }
}

// cp_rows_piece for the cnt (1 to L) particles of a piece
template <int NY, int L>
__device__ __forceinline__ void cp_rows_run(int cnt, const float* rows, int j0,
                                            int j1, int& jn, int nl,
                                            const RowSplit& rs, const float* Cr,
                                            float (&acc)[kCpRun][NY][4]) {
  if constexpr (L > 1) {
    if (cnt < L) {
      cp_rows_run<NY, L - 1>(cnt, rows, j0, j1, jn, nl, rs, Cr, acc);
      return;
    }
  }
  cp_rows_piece<NY, L>(rows, j0, j1, jn, nl, rs, Cr, acc);
}

template <typename T, typename TC, int NY, bool kFactor>
__global__ void __launch_bounds__(kCpThreads, 2)
gather_cp_kernel(const int* __restrict__ bidx, const TC* __restrict__ C,
                 const T* __restrict__ Wt, const T* __restrict__ P_base,
                 float* __restrict__ CP, long long n, long long n_base, int rw,
                 int live, int nl, unsigned long long* __restrict__ reads) {
  static_assert(sizeof(T) == 4 && sizeof(TC) == 4, "the float32 form");
  static_assert((kCpStages & (kCpStages - 1)) == 0, "a power of two");
  constexpr int E = Unit<T>::kElems;
  constexpr int kWarps = kRowThreads / 32;
  extern __shared__ __align__(128) unsigned char cp_smem[];
  __shared__ uint64_t full[kCpStages];
  __shared__ uint64_t empty[kCpStages];
  __shared__ uint64_t cfull[2];
  __shared__ uint64_t cempty[2];
  __shared__ long long scratch[kWarps];
  __shared__ long long first, count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = cp_stage_rows(nl, 4);
  const int n_chunks = (nl + rows - 1) / rows;
  const size_t stage_bytes = (size_t)rows * nl * 4;
  const int sets = row_sets(row_units(nl, 4));
  const bool direct_out = cp_part_sets(nl) == 0;   // sums straight from registers
  float* Cbuf = reinterpret_cast<float*>(cp_smem + kCpStages * stage_bytes);
  float* part = Cbuf + 2 * kCpRun * NY * nl;
  float* CWt = part + (size_t)cp_part_sets(nl) * NY * nl;   // [NY][rw]: -round(C Wt^T)
  if (tid == 0) {
    for (int s = 0; s < kCpStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cempty[s], kWarps);
    }
    mbar_init_fence();
  }
  if (warp < kWarps) block_pieces(bidx, n, n_base, scratch, &first, &count);
  __syncthreads();
  const long long pieces = count;
  if (warp == kWarps) {
    // producer: per piece its C, then (valid bases only) P's rows and each
    // particle's live factor rows through the ring, a stage as soon as the
    // consumers free one; the ring's count k runs on across pieces
    if (lane == 0) {
      int k = 0;
      long long b = first;
      unsigned long long matrices = 0;
      auto stage = [&](const T* from, int nrows) {
        const int s = k & (kCpStages - 1);
        const uint32_t bytes = (uint32_t)((size_t)nrows * nl * 4);
        mbar_wait(&empty[s], (uint32_t)((k / kCpStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        bulk_load(cp_smem + s * stage_bytes, from, bytes, &full[s]);
        ++k;
      };
      for (long long p = 0; p < pieces; ++p) {
        long long src;
        const int cnt = piece_at(bidx, b, n, n_base, &src);
        const int buf = (int)(p & 1);
        const uint32_t cbytes = (uint32_t)(cnt * NY * nl * 4);
        mbar_wait(&cempty[buf], (uint32_t)((p >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&cfull[buf], cbytes);
        bulk_load(Cbuf + buf * kCpRun * NY * nl, C + b * NY * nl, cbytes, &cfull[buf]);
        if (src >= 0) {
          ++matrices;
          const T* Pb = P_base + src * (long long)nl * nl;
          for (int c = 0; c < n_chunks; ++c) {
            stage(Pb + (long long)c * rows * nl, min(rows, nl - c * rows));
          }
          if constexpr (kFactor) {
            for (int q = 0; q < cnt; ++q) {
              for (int r0 = 0; r0 < live; r0 += rows) {
                stage(Wt + ((b + q) * rw + r0) * (long long)nl, min(rows, live - r0));
              }
            }
          }
        }
        b += cnt;
      }
      if (reads != nullptr && matrices > 0) atomicAdd(reads, matrices);
    }
    return;
  }
  const RowSplit rs(nl, 4, tid);
  int k = 0;
  long long b = first;
  for (long long p = 0; p < pieces; ++p) {
    long long src;
    const int cnt = piece_at(bidx, b, n, n_base, &src);
    const int buf = (int)(p & 1);
    const float* Cr = Cbuf + buf * kCpRun * NY * nl;
    float acc[kCpRun][NY][E];
#pragma unroll
    for (int q = 0; q < kCpRun; ++q) {
#pragma unroll
      for (int i = 0; i < NY; ++i) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[q][i][e] = 0.0f;
      }
    }
    mbar_wait(&cfull[buf], (uint32_t)((p >> 1) & 1));
    if (src >= 0) {
      int jn = rs.active ? rs.g : nl;   // this thread's next row of P
      for (int c = 0; c < n_chunks; ++c, ++k) {
        const int s = k & (kCpStages - 1);
        mbar_wait(&full[s], (uint32_t)((k / kCpStages) & 1));
        const float* stage = reinterpret_cast<const float*>(cp_smem + s * stage_bytes);
        const int j0 = c * rows, j1 = min(nl, j0 + rows);
        cp_rows_run<NY, kCpRun>(cnt, stage, j0, j1, jn, nl, rs, Cr, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    // out = C P: with one set of sums a unit (one row group, whole units a
    // thread) straight from the registers, else the sets summed in order
    // through shared memory, a particle at a time
#pragma unroll
    for (int q = 0; q < kCpRun; ++q) {
      if (q >= cnt) break;
      float* out = CP + (b + q) * NY * nl;
      if (src < 0) {
        for (int idx = tid; idx < NY * nl; idx += kRowThreads) out[idx] = quiet_nan();
      } else if (direct_out) {
        if (rs.active) {
#pragma unroll
          for (int i = 0; i < NY; ++i) {
            *reinterpret_cast<float4*>(out + i * nl + rs.u * E) =
                make_float4(acc[q][i][0], acc[q][i][1], acc[q][i][2], acc[q][i][3]);
          }
        }
      } else {
        cp_partial_store<NY, E>(acc[q], rs, part, nl, lane);
        consumer_sync();
        for (int idx = tid; idx < NY * nl; idx += kRowThreads) {
          out[idx] = cp_partial_sum<NY>(part, sets, nl, idx);
        }
        consumer_sync();   // part is written again
      }
    }
    if (kFactor && live > 0 && src >= 0) {
      // out += -round(C Wt^T) Wt: each particle's staged factor rows get
      // their coefficients (a warp a row, lanes over the columns) and enter
      // sums of their own by the same row split, added to out in order
#pragma unroll 1
      for (int q = 0; q < cnt; ++q) {
        const float* Cq = Cr + q * NY * nl;
        float* out = CP + (b + q) * NY * nl;
        float fac[NY][E];
#pragma unroll
        for (int i = 0; i < NY; ++i) {
#pragma unroll
          for (int e = 0; e < E; ++e) fac[i][e] = 0.0f;
        }
        for (int r0 = 0; r0 < live; r0 += rows, ++k) {
          const int s = k & (kCpStages - 1);
          const int r1 = min(live, r0 + rows);
          mbar_wait(&full[s], (uint32_t)((k / kCpStages) & 1));
          const float* W = reinterpret_cast<const float*>(cp_smem + s * stage_bytes);
          for (int r = r0 + warp; r < r1; r += kWarps) {
            float cw[NY];
#pragma unroll
            for (int i = 0; i < NY; ++i) cw[i] = 0.0f;
            for (int j = lane; j < nl; j += 32) {
              const float w = W[(size_t)(r - r0) * nl + j];
#pragma unroll
              for (int i = 0; i < NY; ++i) cw[i] = fmaf(Cq[i * nl + j], w, cw[i]);
            }
#pragma unroll
            for (int i = 0; i < NY; ++i) {
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) {
                cw[i] += __shfl_xor_sync(0xffffffffu, cw[i], off);
              }
            }
            if (lane == 0) {
#pragma unroll
              for (int i = 0; i < NY; ++i) CWt[i * rw + r] = -storage_round<T>(cw[i]);
            }
          }
          consumer_sync();
          cp_rows<T, NY>(W, r0, r1, nl, rs, CWt, rw, fac);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        if (direct_out) {
          if (rs.active) {
#pragma unroll
            for (int i = 0; i < NY; ++i) {
              float4* o = reinterpret_cast<float4*>(out + i * nl + rs.u * E);
              const float4 v = *o;
              *o = make_float4(v.x + fac[i][0], v.y + fac[i][1], v.z + fac[i][2],
                               v.w + fac[i][3]);
            }
          }
        } else {
          cp_partial_store<NY, E>(fac, rs, part, nl, lane);
          consumer_sync();
          for (int idx = tid; idx < NY * nl; idx += kRowThreads) {
            out[idx] += cp_partial_sum<NY>(part, sets, nl, idx);
          }
        }
        consumer_sync();   // CWt and part are written again
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&cempty[buf]);   // the piece's C is read no more
    b += cnt;
  }
}

// ---- the rebase ----------------------------------------------------------
// P'[b] = P_src - round(Wt[b]^T Wt[b]) in the storage dtype   (K3)
// P_src = P_base[bidx[b]] with kGather, else 0 (bidx and P_base are never
// read); the product and the subtraction only with kDot (else Wt is never
// read and P' = P_src).
//
// Bound: the bytes (one gathered read and one write of P, 2*nl*nl*itemsize
// a particle); the rank-rw product is 2*rw flops an element, a few
// hundredths of a millisecond on the tensor cores at bf16 and a third of
// the byte time as f32 FMA at nl=512. Loads of 4 or 8 bytes a thread that
// start only once Wt is staged, and a product fed from shared memory at 9
// loads per 16 FMA on the CUDA cores, leave the kernel at half the bytes'
// rate at bf16. This design:
//  - without the product the kernel is a copy: the piece-major gather above
//    (gather_piece, one warp a block), or 16-byte stores of zeros
//    (zero_run);
//  - with it, one block per particle: a producer warp brings Wt[b] and then
//    P_src in row blocks (a stage is whole rows, contiguous in memory) into
//    a ring of kRebaseStages stages by bulk copies, so no thread waits on a
//    global load and the copy and the product overlap; eight consumer warps
//    take the items of each stage in turn (full / empty mbarriers per
//    stage), subtract and store 16 bytes a thread. Three blocks an SM
//    (registers capped for it) hide a block's start-up behind its
//    neighbours;
//  - bf16: Wt[b] stays bf16 in shared memory, rows zero-padded to a multiple
//    of 16 and strided by nl + 8 elements (conflict-free ldmatrix); an item
//    is 16 rows x 64 columns of Wt^T Wt by mma.sync.m16n8k16 (bf16 in, f32
//    accumulation) with both operands from ldmatrix.trans; the accumulators
//    pass through a padded per-warp tile so that the epilogue works on 16
//    contiguous bytes;
//  - f32: full f32 FMA (no TF32); an item is 4 rows x 128 columns, a thread
//    4 x 4 of it from two 16-byte shared loads per factor row (the row
//    entries broadcast).
// Blocks run particle by particle, so a duplicate index is served by L2
// only when its twin is read at about the same time (neighbours in bidx,
// as sorted ancestors give); on far-apart duplicates the kernel moves all
// 2*N matrices and runs at the memory's rate for that.
constexpr int kRebaseWarps = 8;                       // consumer warps
constexpr int kRebaseThreads = 32 * (kRebaseWarps + 1);  // and the producer
constexpr int kRebaseStages = 4;
constexpr int kRebaseBlocksPerSM = 3;   // caps registers at 72 a thread
constexpr int kMmaItemCols = 64;   // bf16 item: 16 rows x 64 columns
constexpr int kMmaTileLd = kMmaItemCols + 8;
constexpr int kFmaItemCols = 128;  // f32 item: 4 rows x 128 columns

template <typename T> struct RebaseShape;
template <> struct RebaseShape<__nv_bfloat16> {
  static constexpr int kRowBlock = 16;
  static constexpr int kStageBytes = 8192;
};
template <> struct RebaseShape<float> {
  static constexpr int kRowBlock = 4;
  static constexpr int kStageBytes = 16384;
};

// rows of P in one stage: whole row blocks, about kStageBytes
template <typename T>
__host__ __device__ int rebase_stage_rows(int nl) {
  constexpr int rb = RebaseShape<T>::kRowBlock;
  int rows = RebaseShape<T>::kStageBytes / (nl * (int)sizeof(T)) / rb * rb;
  if (rows < rb) rows = rb;
  const int all = round_up(nl, rb);
  return rows < all ? rows : all;
}

// bytes of the staged factor (and, at bf16, the per-warp accumulator tiles)
template <typename T>
__host__ __device__ size_t rebase_factor_bytes(int rw, int nl) {
  if (sizeof(T) == 4) return (size_t)rw * nl * 4;
  return (size_t)round_up(rw, 16) * (round_up(nl, 16) + 8) * 2 +
         (size_t)kRebaseWarps * 16 * kMmaTileLd * 2;
}

// dynamic shared memory of rebase_kernel<T, kGather, kDot>
template <typename T>
size_t rebase_smem_bytes(bool gather, bool dot, int rw, int nl) {
  if (!dot) return gather ? kGatherPiece : 0;
  const size_t ring = gather ? (size_t)kRebaseStages * rebase_stage_rows<T>(nl) *
                                   nl * sizeof(T)
                             : 0;
  return ring + rebase_factor_bytes<T>(rw, nl);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The staged factor. f32: Ws [rw][nl], one bulk copy. bf16: Ws [round_up(rw,
// 16)][ldw] with ldw = round_up(nl, 16) + 8, one bulk copy a row (the row
// stride keeps ldmatrix free of bank conflicts); the consumers zero what
// the copies leave out (rows from rw on, columns from nl on).
template <typename T>
__device__ void load_factor(const T* __restrict__ Wb, unsigned char* ws, int rw,
                            int nl, uint64_t* bar) {
  mbar_arrive_expect_tx(bar, (uint32_t)(rw * nl * sizeof(T)));
  if (rw == 0) return;
  if (sizeof(T) == 4) {
    bulk_load(ws, Wb, (uint32_t)(rw * nl * 4), bar);
  } else {
    const int ldw = round_up(nl, 16) + 8;
    for (int r = 0; r < rw; ++r) {
      bulk_load(ws + (size_t)r * ldw * 2, Wb + (size_t)r * nl, (uint32_t)(nl * 2), bar);
    }
  }
}
__device__ void zero_factor_padding(unsigned char* ws, int rw, int nl, int tid,
                                    int nthreads) {
  const int units = (round_up(nl, 16) + 8) / 8;   // 16-byte units a row
  const int total = round_up(rw, 16) * units;
  for (int i = tid; i < total; i += nthreads) {
    if (i / units >= rw || (i % units) * 8 >= nl) {
      reinterpret_cast<uint4*>(ws)[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

// One bf16 item: rows [i0, i0 + 16) x columns [j0, j0 + 64) of the matrix.
// src: this stage's row i0 (shared memory), or nullptr for P_src = fill.
__device__ void rebase_item(const __nv_bfloat16* ws, int ldw, int rwp,
                            __nv_bfloat16* tile, const __nv_bfloat16* src,
                            float fill, __nv_bfloat16* __restrict__ Ob, int i0,
                            int j0, int nl, int lane) {
  constexpr int kTiles = kMmaItemCols / 8;
  float acc[kTiles][4];
#pragma unroll
  for (int q = 0; q < kTiles; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  const int mi = lane >> 3, lr = lane & 7;
  for (int k0 = 0; k0 < rwp; k0 += 16) {
    uint32_t a[4];
    // A = Wt^T: the 8x8 blocks (k0, i0), (k0, i0+8), (k0+8, i0), (k0+8, i0+8)
    ldmatrix_x4_trans(a, ws + (k0 + (mi >> 1) * 8 + lr) * ldw + i0 + (mi & 1) * 8);
#pragma unroll
    for (int q = 0; q < kTiles; q += 2) {
      const int j = j0 + q * 8;
      if (j < nl) {   // warp-uniform; columns up to round_up(nl, 16) are staged
        uint32_t bfrag[4];
        // B = Wt: (k0, j), (k0+8, j), (k0, j+8), (k0+8, j+8)
        ldmatrix_x4_trans(bfrag, ws + (k0 + (mi & 1) * 8 + lr) * ldw + j + (mi >> 1) * 8);
        mma_bf16_16816(acc[q], a, bfrag[0], bfrag[1]);
        mma_bf16_16816(acc[q + 1], a, bfrag[2], bfrag[3]);
      }
    }
  }
  // the rounded product into the warp's tile [16][kMmaTileLd]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < kTiles; ++q) {
    *reinterpret_cast<__nv_bfloat162*>(tile + g * kMmaTileLd + q * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[q][0], acc[q][1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8) * kMmaTileLd + q * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[q][2], acc[q][3]);
  }
  __syncwarp();
  // epilogue: 16 rows x 8 units of 8 columns, four units a lane
#pragma unroll
  for (int v = 0; v < 16 * (kMmaItemCols / 8) / 32; ++v) {
    const int u = lane + 32 * v;
    const int row = u / (kMmaItemCols / 8), col = j0 + (u % (kMmaItemCols / 8)) * 8;
    if (i0 + row < nl && col < nl) {
      const uint4 dv = *reinterpret_cast<const uint4*>(tile + row * kMmaTileLd + col - j0);
      uint4 pv;
      if (src != nullptr) pv = *reinterpret_cast<const uint4*>(src + row * nl + col);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
      uint4 ov;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 d = __bfloat1622float2(d2[e]);
        const float2 p = src != nullptr ? __bfloat1622float2(p2[e])
                                        : make_float2(fill, fill);
        o2[e] = __floats2bfloat162_rn(p.x - d.x, p.y - d.y);
      }
      *reinterpret_cast<uint4*>(Ob + (long long)(i0 + row) * nl + col) = ov;
    }
  }
  __syncwarp();   // the tile is written again by the next item
}

// One f32 item: rows [i0, i0 + 4) x columns [j0, j0 + 128).
__device__ void rebase_item(const float* ws, int rw, const float* src,
                            float fill, float* __restrict__ Ob, int i0, int j0,
                            int nl, int lane) {
  const int j = j0 + 4 * lane;
  if (j >= nl) return;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < rw; ++r) {
    const float4 wj = *reinterpret_cast<const float4*>(ws + r * nl + j);
    const float4 wi = *reinterpret_cast<const float4*>(ws + r * nl + i0);
    const float wr[4] = {wi.x, wi.y, wi.z, wi.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[a][0] = fmaf(wr[a], wj.x, acc[a][0]);
      acc[a][1] = fmaf(wr[a], wj.y, acc[a][1]);
      acc[a][2] = fmaf(wr[a], wj.z, acc[a][2]);
      acc[a][3] = fmaf(wr[a], wj.w, acc[a][3]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 p = src != nullptr
                         ? *reinterpret_cast<const float4*>(src + a * nl + j)
                         : make_float4(fill, fill, fill, fill);
    const float4 o = make_float4(p.x - acc[a][0], p.y - acc[a][1],
                                 p.z - acc[a][2], p.w - acc[a][3]);
    *reinterpret_cast<float4*>(Ob + (long long)(i0 + a) * nl + j) = o;
  }
}

template <typename T, bool kGather, bool kDot>
__global__ void __launch_bounds__(kRebaseThreads, kRebaseBlocksPerSM)
rebase_kernel(const int* __restrict__ bidx, const T* __restrict__ Wt,
              const T* __restrict__ P_base, T* __restrict__ P_out, long long n,
              long long n_base, int rw, int nl) {
  extern __shared__ __align__(128) unsigned char rebase_smem[];
  __shared__ uint64_t full[kRebaseStages];
  __shared__ uint64_t empty[kRebaseStages];
  __shared__ uint64_t wfull;
  if constexpr (!kDot) {
    if constexpr (kGather) {
      gather_piece<T>(bidx, P_base, P_out, n, n_base, nl, rebase_smem, full);
    } else {
      zero_run<T>(P_out, n, nl);
    }
  } else {
    constexpr int rb = RebaseShape<T>::kRowBlock;
    const long long b = blockIdx.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int stage_rows = rebase_stage_rows<T>(nl);
    const int n_chunks = (nl + stage_rows - 1) / stage_rows;
    const size_t stage_bytes = (size_t)stage_rows * nl * sizeof(T);
    unsigned char* ws = rebase_smem + (kGather ? kRebaseStages * stage_bytes : 0);
    if (tid == 0) {
      for (int s = 0; s < kRebaseStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kRebaseWarps);
      }
      mbar_init(&wfull, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (warp == kRebaseWarps) {
      // producer: the factor, then P_src: refill each stage as soon as the
      // consumers have left it
      if (lane == 0) {
        load_factor<T>(Wt + b * (long long)rw * nl, ws, rw, nl, &wfull);
        if constexpr (kGather) {
          const long long src = bidx[b];
          if (src >= 0 && src < n_base) {
            const T* Pb = P_base + src * (long long)nl * nl;
            for (int k = 0; k < n_chunks; ++k) {
              const int s = k % kRebaseStages;
              const int rows = min(stage_rows, nl - k * stage_rows);
              const uint32_t bytes = (uint32_t)(rows * nl * sizeof(T));
              mbar_wait(&empty[s], ((k / kRebaseStages) & 1) ^ 1);
              mbar_arrive_expect_tx(&full[s], bytes);
              bulk_load(rebase_smem + s * stage_bytes,
                        Pb + (long long)k * stage_rows * nl, bytes, &full[s]);
            }
          }
        }
      }
      return;
    }
    bool stream = false;   // P_src comes through the ring
    if constexpr (kGather) {
      const long long src = bidx[b];
      stream = src >= 0 && src < n_base;
    }
    if constexpr (sizeof(T) == 2) {
      zero_factor_padding(ws, rw, nl, tid, 32 * kRebaseWarps);
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kRebaseWarps) : "memory");
    }
    mbar_wait(&wfull, 0);

    const float fill = kGather ? quiet_nan() : 0.0f;
    T* Ob = P_out + b * (long long)nl * nl;
    constexpr int item_cols = sizeof(T) == 4 ? kFmaItemCols : kMmaItemCols;
    const int col_items = (nl + item_cols - 1) / item_cols;
    const int stage_items = stage_rows / rb * col_items;
    for (int k = 0; k < n_chunks; ++k) {
      const int s = k % kRebaseStages;
      const int rows = min(stage_rows, nl - k * stage_rows);
      const int items = (rows + rb - 1) / rb * col_items;
      if (stream) mbar_wait(&full[s], (k / kRebaseStages) & 1);
      const T* stage = reinterpret_cast<const T*>(rebase_smem + s * stage_bytes);
      // items go round the warps across stages, so a stage with fewer
      // items than warps still keeps every warp busy
      int first = (warp - k * stage_items) % kRebaseWarps;
      if (first < 0) first += kRebaseWarps;
      for (int it = first; it < items; it += kRebaseWarps) {
        const int ri = it / col_items * rb, j0 = it % col_items * item_cols;
        const T* src = stream ? stage + ri * nl : nullptr;
        const int i0 = k * stage_rows + ri;
        if constexpr (sizeof(T) == 4) {
          rebase_item(reinterpret_cast<const float*>(ws), rw, src, fill, Ob, i0,
                      j0, nl, lane);
        } else {
          const int ldw = round_up(nl, 16) + 8;
          __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(
              ws + (size_t)round_up(rw, 16) * ldw * 2) + warp * 16 * kMmaTileLd;
          rebase_item(reinterpret_cast<const __nv_bfloat16*>(ws), ldw,
                      round_up(rw, 16), tile, src, fill, Ob, i0, j0, nl, lane);
        }
      }
      if (stream) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
  }
}

// ---- the gathered C P at bf16: one read of P a run of equal bases -------
// The bf16 form of K2 (and of K8, with the factor term compiled out):
//     CP[b] = round(C[b]) P_base[bidx[b]] - round(C[b] Wt[b]^T) Wt[b]
// with only the first `rows` factor rows of Wt[b] read (the rows from
// `rows` on are zero, so they add nothing).
// Bound: the bytes, each distinct P_base matrix of a tile read once, C and
// the live rows of Wt read once, CP written once; the products, 2 ny nl
// (nl + 2 rows) flops a particle, hide under them on the CUDA cores.
// What the direct form above pays beyond that: it reads P again for every
// particle of a run of equal base indices (on the filter's main path the
// base indices are arange composed with sorted systematic ancestors, so
// equal ones stand side by side), reads Wt twice from global memory (C Wt^T
// with 2-byte loads, then the correction), and multiplies every factor row,
// live or not.
// Design: the direct form's shape, whose small blocks (one thread a column
// pair of P, streamed from global memory) keep many independent loads in
// flight, with
//  - kRunTile consecutive particles a block: a run of equal valid base
//    indices among them streams its P once, each row feeding every particle
//    of the run (a run longer than a tile is read once a tile: neighbouring
//    blocks run at about the same time, so the second read comes from L2);
//  - the live factor rows of the tile's particles staged in shared memory
//    once, kRunWRows rows of each at a time, by 16-byte cp.async copies
//    (the first chunk lands while P streams); round(C Wt^T) from there
//    (half a warp a factor row, 16-byte units, summed by shuffles), and the
//    correction from there too, summed a factor row at a time in order in
//    accumulators of its own and added to C P at the end, so that a zero
//    factor row adds an exact zero and `rows` gives the bits of all rows.
// A wider tile or a 256-thread block keeps fewer particles in flight (shared
// memory per block grows with the tile) and measured slower on the H100; a
// ring of bulk-copied stages fed by a producer warp, with the products on
// the tensor cores, measured slower than the direct form even with its
// arithmetic compiled out.
// Shared memory: C rounded to bf16, as floats [kRunTile][NY][nl];
// round(C Wt^T) [kRunTile][NY][kRunWRows]; the staged factor rows
// [kRunTile][kRunWRows][nl] bf16.
constexpr int kRunTile = 2;      // particles a block
constexpr int kRunWRows = 16;    // factor rows of each particle a staged chunk
constexpr int kRunMaxCols = 512;

inline __host__ __device__ int run_threads(int nl) {   // one a column pair
  return round_up(nl / 2, 32);
}
inline size_t gather_cp_runs_smem(int ny, int nl, bool factor) {
  return (size_t)kRunTile * ny * nl * 4 +
         (factor ? (size_t)kRunTile * (ny * kRunWRows * 4 + kRunWRows * nl * 2) : 0);
}

// acc[l] += round(C_l) P over P's rows, for this thread's column pair k:
// the L particles whose C [NY][nl] follow each other from Cq share P [nl, nl]
template <int NY, int L>
__device__ __forceinline__ void run_pass(const __nv_bfloat16* __restrict__ Pb,
                                         const float* Cq, int k, int nl,
                                         float (&acc)[L][NY][2]) {
#pragma unroll 8
  for (int j = 0; j < nl; ++j) {
    const float2 p = load_pair(Pb + (long long)j * nl + k);
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        const float c = Cq[(l * NY + i) * nl + j];
        acc[l][i][0] = fmaf(c, p.x, acc[l][i][0]);
        acc[l][i][1] = fmaf(c, p.y, acc[l][i][1]);
      }
    }
  }
}

// 8 elements of C from global memory, rounded to bf16, as floats
__device__ __forceinline__ void load_c8(const __nv_bfloat16* p, float (&v)[8]) {
  load_unit(p, v);
}
__device__ __forceinline__ void load_c8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = storage_round<__nv_bfloat16>(f[e]);
}

// 16 bytes from global to shared memory, asynchronously (cp.async, kept
// in L2 only); cp_async_wait_all waits for this thread's copies
__device__ __forceinline__ void cp_async_16(void* dst_smem, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst_smem)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename TC, int NY, bool kFactor>
__global__ void __launch_bounds__(256)
gather_cp_runs_kernel(const int* __restrict__ bidx, const TC* __restrict__ C,
                      const __nv_bfloat16* __restrict__ Wt,
                      const __nv_bfloat16* __restrict__ P_base,
                      float* __restrict__ CP, long long n, long long n_base,
                      int rw, int rows, int nl) {
  using bf16 = __nv_bfloat16;
  static_assert(kRunTile == 2, "a tile's runs are one pair or two singles");
  extern __shared__ __align__(16) float run_smem[];
  float* Cs = run_smem;                                         // [T][NY][nl]
  float* CWt = Cs + kRunTile * NY * nl;                         // [T][NY][kRunWRows]
  bf16* Ws = reinterpret_cast<bf16*>(CWt + kRunTile * NY * kRunWRows);  // [T][kRunWRows][nl]
  __shared__ int src[kRunTile];   // base indices, -1 where out of range
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, half = lane >> 4, l16 = lane & 15;
  const long long b0 = (long long)blockIdx.x * kRunTile;
  const int cnt = (int)min((long long)kRunTile, n - b0);
  const int k = 2 * tid;     // this thread's column pair
  const int units = nl / 8;  // 16-byte units of a bf16 row
  if (tid < cnt) {
    const long long s = bidx[b0 + tid];
    src[tid] = s >= 0 && s < n_base ? (int)s : -1;
  }
  // a chunk of up to kRunWRows live factor rows of each particle into
  // shared memory, by cp.async (the first chunk flies while P streams)
  auto stage_chunk = [&](int r0) {
    const int nr = min(kRunWRows, rows - r0);
    for (int e = tid; e < cnt * nr * units; e += nthreads) {
      const int q = e / (nr * units), ru = e - q * nr * units;
      cp_async_16(Ws + (size_t)q * kRunWRows * nl + 8 * ru,
                  Wt + ((b0 + q) * rw + r0) * nl + 8 * ru);
    }
  };
  if (kFactor && rows > 0) stage_chunk(0);
  // C of the tile's particles (contiguous), rounded to bf16
  const TC* Cb = C + b0 * NY * nl;
  for (int u = tid; u < cnt * NY * units; u += nthreads) {
    float v[8];
    load_c8(Cb + 8 * u, v);
    *reinterpret_cast<float4*>(Cs + 8 * u) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(Cs + 8 * u + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
  const int s0 = src[0], s1 = cnt > 1 ? src[1] : -1;
  // C P: a run of two streams its P once for both
  float acc[kRunTile][NY][2] = {};
  if (k < nl) {
    if (s0 >= 0 && s0 == s1) {
      run_pass<NY, 2>(P_base + (long long)s0 * nl * nl, Cs, k, nl, acc);
    } else {
      float a1[1][NY][2] = {};
      if (s0 >= 0) {
        run_pass<NY, 1>(P_base + (long long)s0 * nl * nl, Cs, k, nl, a1);
#pragma unroll
        for (int i = 0; i < NY; ++i) acc[0][i][0] = a1[0][i][0], acc[0][i][1] = a1[0][i][1];
      }
      if (s1 >= 0) {
        float a2[1][NY][2] = {};
        run_pass<NY, 1>(P_base + (long long)s1 * nl * nl, Cs + NY * nl, k, nl, a2);
#pragma unroll
        for (int i = 0; i < NY; ++i) acc[1][i][0] = a2[0][i][0], acc[1][i][1] = a2[0][i][1];
      }
    }
  }
  if constexpr (kFactor) {
    // the correction -round(C Wt^T) Wt, summed a factor row at a time in
    // order (a zero row adds an exact zero), added to C P at the end
    float cr[kRunTile][NY][2] = {};
    for (int r0 = 0; r0 < rows; r0 += kRunWRows) {
      const int nr = min(kRunWRows, rows - r0);
      if (r0 > 0) stage_chunk(r0);
      cp_async_wait_all();
      __syncthreads();
      // round(C Wt^T): half a warp a (particle, factor row); the loop runs
      // alike for both halves of a warp (the shuffles take all its lanes)
      for (int t2 = 2 * warp; t2 < cnt * nr; t2 += nthreads / 16) {
        const int t = t2 + half, q = t / nr, r = t - q * nr;
        const bool on = t < cnt * nr && src[q] >= 0;
        float sum[NY];
#pragma unroll
        for (int i = 0; i < NY; ++i) sum[i] = 0.0f;
        for (int u = l16; on && u < units; u += 16) {
          float w[8];
          load_unit(Ws + (q * kRunWRows + r) * nl + 8 * u, w);
#pragma unroll
          for (int i = 0; i < NY; ++i) {
            const float* c = Cs + (q * NY + i) * nl + 8 * u;
            const float4 c0 = *reinterpret_cast<const float4*>(c);
            const float4 c1 = *reinterpret_cast<const float4*>(c + 4);
            sum[i] = fmaf(c0.x, w[0], sum[i]);
            sum[i] = fmaf(c0.y, w[1], sum[i]);
            sum[i] = fmaf(c0.z, w[2], sum[i]);
            sum[i] = fmaf(c0.w, w[3], sum[i]);
            sum[i] = fmaf(c1.x, w[4], sum[i]);
            sum[i] = fmaf(c1.y, w[5], sum[i]);
            sum[i] = fmaf(c1.z, w[6], sum[i]);
            sum[i] = fmaf(c1.w, w[7], sum[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < NY; ++i) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
          }
        }
        if (on && l16 == 0) {
#pragma unroll
          for (int i = 0; i < NY; ++i) {
            CWt[(q * NY + i) * kRunWRows + r] = storage_round<bf16>(sum[i]);
          }
        }
      }
      __syncthreads();
      if (k < nl) {
#pragma unroll
        for (int q = 0; q < kRunTile; ++q) {
          if (q < cnt && src[q] >= 0) {
            for (int r = 0; r < nr; ++r) {
              const float2 w = load_pair(Ws + (q * kRunWRows + r) * nl + k);
#pragma unroll
              for (int i = 0; i < NY; ++i) {
                const float c = CWt[(q * NY + i) * kRunWRows + r];
                cr[q][i][0] = fmaf(-c, w.x, cr[q][i][0]);
                cr[q][i][1] = fmaf(-c, w.y, cr[q][i][1]);
              }
            }
          }
        }
      }
      __syncthreads();   // Ws and CWt are written again by the next chunk
    }
#pragma unroll
    for (int q = 0; q < kRunTile; ++q) {
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        acc[q][i][0] += cr[q][i][0];
        acc[q][i][1] += cr[q][i][1];
      }
    }
  }
  if (k >= nl) return;
#pragma unroll
  for (int q = 0; q < kRunTile; ++q) {
    if (q < cnt) {
      const bool ok = (q == 0 ? s0 : s1) >= 0;
#pragma unroll
      for (int i = 0; i < NY; ++i) {
        store_pair(CP + ((b0 + q) * NY + i) * nl + k, ok ? acc[q][i][0] : quiet_nan(),
                   ok ? acc[q][i][1] : quiet_nan());
      }
    }
  }
}

// K2's form (K8's without the factor): at f32 kCpRunsF32 (the ring of
// pieces above) where a row has at most 256 16-byte units and the block's
// shared memory fits, else kCpDirect; at bf16 kCpRuns up to nl = 512 (one
// thread a column pair, 256 at most), else kCpDirect. At bf16 a ring lost
// to the direct form on the H100: the direct form's small blocks (2 warps
// at nl=128, 32 an SM) keep more particles in flight than the ring's, and
// than 256-thread blocks that each read one particle's P 16 bytes a thread
// (4 an SM at 64 registers: 0.27 against 0.22 ms for K8).
inline int gather_cp_plan(int ny, int rw, int nl, int itemsize, bool factor) {
  if (itemsize == 2) {
    return nl <= kRunMaxCols ? kCpRuns : kCpDirect;   // 64 KB of shared memory at most
  }
  if (row_units(nl, itemsize) <= kRowThreads &&
      gather_cp_smem(ny, rw, nl, factor) <= kSmemBudget)
    return kCpRunsF32;
  return kCpDirect;
}

template <typename TC, int NY, bool kFactor>
cudaError_t launch_gather_cp_runs(const void* bidx, const void* C, const void* Wt,
                                  const void* P_base, void* CP, long long n,
                                  long long n_base, int rw, int rows, int nl,
                                  cudaStream_t s) {
  const size_t smem = gather_cp_runs_smem(NY, nl, kFactor);
  cudaError_t err = allow_smem(gather_cp_runs_kernel<TC, NY, kFactor>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kRunTile - 1) / kRunTile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_cp_runs_kernel<TC, NY, kFactor><<<(unsigned)blocks, run_threads(nl), smem, s>>>(
      static_cast<const int*>(bidx), static_cast<const TC*>(C),
      static_cast<const __nv_bfloat16*>(Wt), static_cast<const __nv_bfloat16*>(P_base),
      static_cast<float*>(CP), n, n_base, rw, rows, nl);
  return cudaGetLastError();
}

// Launch K2 (kFactor) or K8 on n particles (n > 0) with the first `rows`
// factor rows of each Wt[b] (0 <= rows <= rw) in the form `plan`, which
// must be gather_cp_plan's choice (the wrapper's mirror of it); with
// `direct` the direct form runs instead (to time the two forms). `reads`
// (the f32 form's count of the P_base matrices it read, added to a device
// int64) may be null: then nothing is counted.
template <typename T, typename TC, int NY, bool kFactor>
cudaError_t launch_gather_cp_kernel(const void* bidx, const void* C,
                                    const void* Wt, const void* P_base,
                                    void* CP, long long n, long long n_base,
                                    int rw, int rows, int nl, int plan,
                                    int direct, void* reads, cudaStream_t s) {
  if (plan != gather_cp_plan(NY, rw, nl, sizeof(T), kFactor) || rows < 0 || rows > rw)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (direct || plan == kCpDirect) {
    int threads = ((nl / 2 + 31) / 32) * 32;   // one thread per column pair
    if (threads > 256) threads = 256;
    const size_t smem = (size_t)(NY * nl + (kFactor ? NY * rw : 0)) * sizeof(float);
    if (smem > kSmemBudget) return cudaErrorInvalidValue;
    err = allow_smem(gather_cp_direct_kernel<T, TC, NY, kFactor>, smem);
    if (err != cudaSuccess) return err;
    gather_cp_direct_kernel<T, TC, NY, kFactor><<<(unsigned)n, threads, smem, s>>>(
        static_cast<const int*>(bidx), static_cast<const TC*>(C),
        static_cast<const T*>(Wt), static_cast<const T*>(P_base),
        static_cast<float*>(CP), n_base, rw, rows, nl);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {
    if (plan != kCpRuns) return cudaErrorInvalidValue;
    return launch_gather_cp_runs<TC, NY, kFactor>(bidx, C, Wt, P_base, CP, n, n_base, rw, rows, nl, s);
  } else {
    const size_t smem = gather_cp_smem(NY, rw, nl, kFactor);
    err = allow_smem(gather_cp_kernel<T, TC, NY, kFactor>, smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = persistent_blocks(gather_cp_kernel<T, TC, NY, kFactor>, kCpThreads, smem, n, &blocks);
    if (err != cudaSuccess) return err;
    gather_cp_kernel<T, TC, NY, kFactor><<<(unsigned)blocks, kCpThreads, smem, s>>>(
        static_cast<const int*>(bidx), static_cast<const TC*>(C),
        static_cast<const T*>(Wt), static_cast<const T*>(P_base),
        static_cast<float*>(CP), n, n_base, rw, rows, nl,
        static_cast<unsigned long long*>(reads));
    return cudaGetLastError();
  }
}

// ---- the rebase where the ring and the staged factor do not fit ---------
// The same function as rebase_kernel<T, kGather, true> at any nl (nl = 2048
// leaves no room for Wt [rw, nl] beside the ring): no shared memory; a
// block of eight warps covers 32 rows of one particle's P', a warp 4 rows x
// 128 columns at a time, each thread a 4 x 4 block from 4-element loads of
// Wt (through L1 and L2: every block of a particle reads all of Wt[b]) and
// of P_src (through registers). f32 FMA over the factor rows in order, the
// product rounded to the storage dtype before the subtraction.
constexpr int kWideRows = 32;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = c.x;
  v[3] = c.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 x;
  *reinterpret_cast<__nv_bfloat162*>(&x.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&x.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename T, bool kGather>
__global__ void __launch_bounds__(256)
rebase_wide_kernel(const int* __restrict__ bidx, const T* __restrict__ Wt,
                   const T* __restrict__ P_base, T* __restrict__ P_out,
                   long long n_base, int rw, int nl, long long row_blocks) {
  const long long b = blockIdx.x / row_blocks;
  const int i0 = (int)(blockIdx.x % row_blocks) * kWideRows + (threadIdx.x >> 5) * 4;
  const int lane = threadIdx.x & 31;
  if (i0 >= nl) return;   // nl is a multiple of 8: rows i0 .. i0 + 3 exist
  long long src = 0;
  bool ok = true;
  if constexpr (kGather) {
    src = bidx[b];
    ok = src >= 0 && src < n_base;
  }
  const T* Wb = Wt + b * (long long)rw * nl;
  const T* Pb = P_base + (ok ? src : 0) * (long long)nl * nl;
  T* Ob = P_out + b * (long long)nl * nl;
  const float fill = kGather ? quiet_nan() : 0.0f;
  for (int j = 4 * lane; j < nl; j += 128) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < rw; ++r) {
      float wi[4], wj[4];
      load4(Wb + (long long)r * nl + i0, wi);
      load4(Wb + (long long)r * nl + j, wj);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(wi[a], wj[c], acc[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float p[4] = {fill, fill, fill, fill};
      if (kGather && ok) load4(Pb + (long long)(i0 + a) * nl + j, p);
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = p[c] - storage_round<T>(acc[a][c]);
      store4(Ob + (long long)(i0 + a) * nl + j, o);
    }
  }
}

// 0: rebase_kernel (bulk-copy ring, staged factor); 1: rebase_wide_kernel,
// where the product's ring and factor do not fit shared memory
template <typename T>
int rebase_variant(bool gather, bool dot, int rw, int nl) {
  return dot && rebase_smem_bytes<T>(gather, dot, rw, nl) > kMaxSmem ? 1 : 0;
}

// Launch rebase_kernel<T, kGather, kDot> (or, for variant 1,
// rebase_wide_kernel<T, kGather>) on n particles (n > 0); `variant` must be
// rebase_variant's choice (the wrapper's mirror of it).
template <typename T, bool kGather, bool kDot>
cudaError_t launch_rebase_kernel(const void* bidx, const void* Wt,
                                 const void* P_base, void* P_out, long long n,
                                 long long n_base, int rw, int nl, int variant,
                                 cudaStream_t s) {
  if (variant != rebase_variant<T>(kGather, kDot, rw, nl)) return cudaErrorInvalidValue;
  if (variant == 1) {
    const long long row_blocks = (nl + kWideRows - 1) / kWideRows;
    if (n * row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rebase_wide_kernel<T, kGather><<<(unsigned)(n * row_blocks), 256, 0, s>>>(
        static_cast<const int*>(bidx), static_cast<const T*>(Wt),
        static_cast<const T*>(P_base), static_cast<T*>(P_out), n_base, rw, nl,
        row_blocks);
    return cudaGetLastError();
  }
  const size_t smem = rebase_smem_bytes<T>(kGather, kDot, rw, nl);
  cudaError_t err = allow_smem(rebase_kernel<T, kGather, kDot>, smem);
  if (err != cudaSuccess) return err;
  const long long bytes = n * nl * nl * (long long)sizeof(T);
  const long long blocks = kDot      ? n
                           : kGather ? n * gather_pieces(nl, sizeof(T))
                                     : (bytes + kZeroBytes - 1) / kZeroBytes;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  const unsigned threads = kDot ? kRebaseThreads : kGather ? 32 : kZeroThreads;
  rebase_kernel<T, kGather, kDot><<<grid, threads, smem, s>>>(
      static_cast<const int*>(bidx), static_cast<const T*>(Wt),
      static_cast<const T*>(P_base), static_cast<T*>(P_out), n, n_base, rw, nl);
  return cudaGetLastError();
}

}  // namespace
