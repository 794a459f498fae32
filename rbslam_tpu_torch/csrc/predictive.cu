// The exact GP predictive of the localization weight for Hopper (sm_90a).
//
// K12 predictive  replaces no TPU kernel: it was added for the exact terrain
// model's weight (models/terrain.py::make_terrain_model), whose predictive
// the JAX package leaves to XLA's triangular solve. For each field row
// c = [e_a | g[p, a, :]] (particle p, axis a = row mod 3, g from K4):
//     mean = c' w,        var = sigma2 * || M c ||^2,   M = L^-1,
// with L the lower Cholesky factor of the map's posterior precision. M and
// w come packed in one float32 table, formed once on the host in float64
// (kernels/predictive.py::pack_predictive):
//     B[k, i] = M[i, k] (i < n_lin),  B[k, n_lin] = w[k],  zero elsewhere,
// so the mean is one more output column of the same product, and the
// identity columns of c are one row of B, added to each output. Neither
// C = [I | g], nor M C', nor its square is ever written: a launch reads g
// [rows, m] and writes mean [rows] and var [rows].
//
// Bound: operations. The product M c over all rows is rows * n_lin^2 FFMA
// flops at least (M is lower-triangular): 1.98e11 at the localization
// cell's 196,608 rows of width 1003, 2.95 ms at the card's 67 TFLOP/s
// float32 rate; the bytes (g once, 787 MB) take 0.24 ms.
//
// Design: a SIMT float32 product tiled like an SGEMM. A block owns 128
// rows and walks the output columns in tiles of 128, each tile over the
// depth only up to its last column, since M is lower-triangular; at the
// depths past a tile's first 64 columns those columns are zero and their
// products are skipped (1.11x the least flops at n_lin 1003, a third of
// it the last tile's unused columns). So a block's work is the same
// everywhere and no partial sum leaves it. 256 threads hold 8 x 8 outputs
// each (two 4 x 4 quarters 64 rows and 64 columns apart, so that the
// shared-memory reads of a warp are conflict-free), with each depth's
// fragments read from shared memory while the previous depth's 64 FFMA
// run. g's and B's tiles of depth 32 come through shared memory by
// cp.async in a ring of two stages (g transposed, 4 bytes a copy,
// zero-filled past the rows and past m; B 16 bytes a copy, its padding
// zero), one stage landing while the other is used; the ring runs across
// the column tiles, so a block's pipeline drains only at its end. Two
// blocks share an SM (127 registers a thread, 66,560 bytes of shared
// memory a block). Each output is squared and summed into its thread's
// row sums in registers, in a fixed order (column tiles in turn, columns
// in turn); the 16 threads of a row combine their sums by a fixed
// butterfly of shuffles, and the column n_lin is written as the mean: a
// launch repeats bit for bit. Plain float32 FFMA throughout: no TF32, no
// tensor cores. At the cell's shape it takes 5.35 ms on an H100 SXM at
// 700 W, 55 % of the bound; its products run at 41 TFLOP/s there, where
// cuBLAS's float32 GEMM of [196608, 1000] x [1000, 1024] runs at 49.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 128;             // rows of g a block owns
constexpr int kTileCols = 128;                 // output columns a tile
constexpr int kDepth = 32;                     // depth a stage (B's rows pad m to it)
constexpr int kThreads = 256;
constexpr int kStages = 2;                     // ring of stages in shared memory
constexpr int kAStride = kRowsPerBlock + 4;    // conflict-free transposed copies
constexpr int kARowStep = kThreads / kDepth;   // rows between a thread's g copies
constexpr int kACopies = kRowsPerBlock / kARowStep;
constexpr int kBCopies = kDepth * kTileCols / 4 / kThreads;

static_assert(kStages >= 2, "a ring needs two stages");
static_assert(kBCopies >= 1 && kThreads % kDepth == 0, "copy layout");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  // zero-fill where the source lies past the rows or past m
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// depth stages of a column tile: column i of M is nonzero only at depth
// k <= i, so the tile's last column (or the mean's, n_lin, which needs all
// of g) bounds them
__device__ __forceinline__ int stages_of(int tile, int m) {
  const int j_end = min(m, (tile + 1) * kTileCols - 3);
  return (j_end + kDepth - 1) / kDepth;
}

// the row (column) of a thread's output i (j) in its block's tile
__device__ __forceinline__ int quarter(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

constexpr int kSmemBytes =
    kStages * kDepth * (kAStride + kTileCols) * (int)sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a thread's fragments at depth kk of a stage: rows quarter(ty, 0..7) of
// g, columns quarter(tx, J0..7) of B
template <int J0>
__device__ __forceinline__ void fragments(float (&a)[8], float (&b)[8],
                                          const float* As_s,
                                          const float* Bs_s, int kk, int tx,
                                          int ty) {
  const float* ar = As_s + kk * kAStride;
  const float* br = Bs_s + kk * kTileCols;
  const float4 a0 = ld4(ar + ty * 4), a1 = ld4(ar + 64 + ty * 4);
  const float4 b0 = J0 == 0 ? ld4(br + tx * 4) : make_float4(0, 0, 0, 0);
  const float4 b1 = ld4(br + 64 + tx * 4);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
}

// one stage's products into a thread's 8 x 8 outputs, from its output
// column J0 on: J0 = 4 skips the first column quarter, which is zero at
// the depths of a stage past the tile's first 64 columns
template <int J0>
__device__ __forceinline__ void mac(float (&acc)[8][8], const float* As_s,
                                    const float* Bs_s, int tx, int ty) {
  float a[2][8], b[2][8];
  fragments<J0>(a[0], b[0], As_s, Bs_s, 0, tx, ty);
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    if (kk + 1 < kDepth)
      fragments<J0>(a[(kk + 1) & 1], b[(kk + 1) & 1], As_s, Bs_s, kk + 1, tx,
                    ty);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = J0; j < 8; ++j)
        acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
predictive_kernel(const float* __restrict__ g, const float* __restrict__ B,
                  float sigma2, float* __restrict__ mean,
                  float* __restrict__ var, long long rows, int m, int ldb) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // [kStages][kDepth][kAStride]
  float* Bs = smem + kStages * kDepth * kAStride;    // [kStages][kDepth][kTileCols]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long r0 = (long long)blockIdx.x * kRowsPerBlock;
  // rows of this block (offsets inside the block's 128 rows of g fit 32 bits)
  const int live = (int)min((long long)kRowsPerBlock, rows - r0);
  const int n_lin = m + 3;
  const int n_tiles = (n_lin + 1 + kTileCols - 1) / kTileCols;
  const float* g_blk = g + r0 * m;

  // copies: g at depth tid % kDepth of rows tid / kDepth + kARowStep q; B
  // at depth tid / 32 + 8 q, columns (tid % 32) * 4 .. + 3
  const int a_k = tid % kDepth, a_row = tid / kDepth;
  const int b_k = tid / 32, b_col = (tid % 32) * 4;

  int load_tile = 0, load_stage = 0, load_stages = stages_of(0, m);
  auto issue = [&](int slot) {
    if (load_tile < n_tiles) {
      const int j0 = load_stage * kDepth;
      const bool k_ok = j0 + a_k < m;
#pragma unroll
      for (int q = 0; q < kACopies; ++q) {
        const int row = a_row + kARowStep * q;
        const bool ok = k_ok && row < live;
        copy4(As + (slot * kDepth + a_k) * kAStride + row,
              ok ? g_blk + row * m + j0 + a_k : g, ok);
      }
#pragma unroll
      for (int q = 0; q < kBCopies; ++q) {
        const int k = b_k + 8 * q;
        copy16(Bs + (slot * kDepth + k) * kTileCols + b_col,
               B + (3 + j0 + k) * ldb + load_tile * kTileCols + b_col);
      }
      if (++load_stage == load_stages) {
        ++load_tile;
        load_stage = 0;
        load_stages = stages_of(load_tile, m);
      }
    }
    commit();   // an empty group past the end keeps the count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float ssq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ssq[i] = 0.f;
  const int axis0 = (int)(r0 % 3);

  int slot = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    const int n_stages = stages_of(tile, m);
    const int i0 = tile * kTileCols;
    for (int s = 0; s < n_stages; ++s) {
      wait_groups<kStages - 2>();
      __syncthreads();
      issue((slot + kStages - 1) % kStages);
      const float* As_s = As + slot * kDepth * kAStride;
      const float* Bs_s = Bs + slot * kDepth * kTileCols;
      if (s * kDepth + 3 >= i0 + 64) {
        mac<4>(acc, As_s, Bs_s, tx, ty);
      } else {
        mac<0>(acc, As_s, Bs_s, tx, ty);
      }
      slot = (slot + 1) % kStages;
    }

    // epilogue: add the identity columns' term B[a, i], then square and
    // sum the field columns; the column n_lin is the mean
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lr = quarter(ty, i);
      const float* e = B + ((axis0 + lr) % 3) * ldb + i0;
      const float4 e0 = __ldg(reinterpret_cast<const float4*>(e + tx * 4));
      const float4 e1 = __ldg(reinterpret_cast<const float4*>(e + 64 + tx * 4));
      const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = i0 + quarter(tx, j);
        const float v = acc[i][j] + ev[j];
        if (col < n_lin) {
          ssq[i] = fmaf(v, v, ssq[i]);
        } else if (col == n_lin && lr < live) {
          mean[r0 + lr] = v;
        }
      }
    }
  }
  wait_groups<0>();

  // the 16 threads of a row (lanes of one half-warp) combine their sums
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = ssq[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const int lr = quarter(ty, i);
    if (tx == 0 && lr < live) var[r0 + lr] = sigma2 * s;
  }
}

}  // namespace

// (g, B, sigma2, mean, var, rows, m, ldb, b_rows, stream): g [rows, m]
// float32, the basis gradients of row r = 3 p + a; B [b_rows, ldb] the
// packed table. Refuses a table whose padding does not cover the tiles.
extern "C" int rbs_predictive(const void* g, const void* B, float sigma2,
                              void* mean, void* var, long long rows, int m,
                              int ldb, int b_rows, void* stream) {
  const int n_lin = m + 3;
  if (rows < 1 || m < 1 || ldb % kTileCols != 0 || ldb < n_lin + 1 ||
      (long long)kRowsPerBlock * m > 0x7fffffffLL ||
      b_rows < 3 + (m + kDepth - 1) / kDepth * kDepth ||
      (long long)b_rows * ldb > 0x7fffffffLL ||
      reinterpret_cast<std::uintptr_t>(B) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      predictive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  predictive_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(B), sigma2,
      static_cast<float*>(mean), static_cast<float*>(var), rows, m, ldb);
  return (int)cudaGetLastError();
}
