// Device code shared by the Kalman update kernels (kf_update.cu) and the
// kernel-part probes (probes.cu): storage-dtype helpers, the gathered CP
// contraction (K2, and K8 with the factor term compiled out), the gather by
// asynchronous bulk copies (K10, and inside K9) and the rebase (K3, and K9
// with its gather and its product switched separately). Each translation
// unit instantiates its own copies (anonymous namespace).

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

// keep a particle's P in shared memory up to here (2 blocks/SM)
constexpr size_t kStashBytes = 110 * 1024;
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

inline __host__ __device__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

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

// Launch rebase_kernel<T, kGather, kDot> on n particles (n > 0).
template <typename T, bool kGather, bool kDot>
cudaError_t launch_rebase_kernel(const void* bidx, const void* Wt,
                                 const void* P_base, void* P_out, long long n,
                                 long long n_base, int rw, int nl,
                                 cudaStream_t s) {
  const size_t smem = rebase_smem_bytes<T>(kGather, kDot, rw, nl);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
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
