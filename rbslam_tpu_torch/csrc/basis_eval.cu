// Laplacian-eigenbasis evaluation kernels for Hopper (sm_90a).
//
// K4 grad_basis  replaces rbslam_tpu/kernels/basis_eval.py:_grad_kernel
//     out[p, i, b] = scale * fac_ib cos(a_ib) prod_{j != i} sin(a_jb),
//     a_jb = freq_jb * x_pj + phase_jb                 ([N, d] -> [N, d, m] f32)
// K1 jac3d_rows  replaces rbslam_tpu/kernels/basis_eval.py:_jac3d_rows_kernel
//     C[p, k, col] = sum_i R(q_p)[i, k] g_i[col],  g = [I_3 | grad phi(x_p) | 0]
//     ([N, 3] positions + [N, 4] quaternions -> [N, 3, nl_pad] f32 or bf16)
// K6 phi_basis   replaces rbslam_tpu/kernels/basis_eval.py:_phi_kernel
//     out[p, b] = scale * prod_j sin(a_jb)              ([N, d] -> [N, m] f32)
// K7 jac3d       replaces rbslam_tpu/kernels/basis_eval.py:_jac3d_kernel
//     K1's C in the transposed layout [3, N, nl_pad], f32 only
// K4 and K6 serve d in {1, 2, 3}.
//
// Bound: the output bytes (d * m f32 a particle for K4, 3 * nl_pad
// elements for K1 and K7, m for K6); at N = 16384 they take 3.9-7.4 us
// of the memory's 3.35 TB/s. At the smoothers' ensemble sizes (N = 100)
// the launch itself is the floor.
//
// Table form (K4, K1, K7). The phase a_jb depends on the column b only
// through the index n_jb, and a few distinct values of n_jb serve all m
// columns (11, 11, 2 of them at m = 125 on the bean_6D domain, 18, 17, 3
// at m = 509 and 512: 24 and 38 sincosf a particle for 3 m): the host
// packs, per dimension, the distinct (freq, phase, fac) triplets, and per
// output column (K1, K7) or per flat output position (K4) a code holding
// the table offsets it needs, a byte each. A block takes several
// particles (basis_plan chooses how many) in two phases. Phase 1: its
// threads evaluate sincosf once per particle and distinct phase into a
// shared-memory table of (sin, fac * cos), and R(q) nine threads a
// particle, one an entry. Phase 2, after one barrier: each thread writes 16 bytes at a
// time (8 bf16 or 4 f32 columns of all three rows of K1 or K7; 4
// consecutive floats of the block's flat [P, d, m] range for K4), its
// codes read 16 bytes at a time through L1 and its sines and cosines from
// the table. The same index gives the same f32 freq and phase, so the
// same sincosf input and the same bits: every product is formed in the
// direct form's order (fac * cos_i, then * sin_j for j != i in order, then
// * scale; then the rotated sum), rounded operation by operation (no FMA
// contraction), and the output is bit-identical to the direct form's. What
// is left is instruction issue: about 33 instructions a column (24 of them
// the products and sums no reordering may merge), behind phase 1.
//
// Direct form (where the distinct values of all dimensions pass 256, or
// the particles make too few blocks to fill the card, as the smoothers'
// 100 do: there the table's extra phase only lengthens the launch): one
// thread per (particle, column), d full sincosf a thread, the rotation
// computed once per particle into shared memory. K6 runs only this form.
//
// sincosf (full range reduction) is used on purpose: the phase arguments
// reach pi*n/2 + freq*x, where the fast intrinsics lose accuracy. The
// phase and the rotation-weighted sums are rounded as the plain PyTorch
// version rounds them, so kernel and plain version differ only by the
// sin/cos ulps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 128;  // direct form: threads along the column axis
constexpr int kRows = 2;    // direct form: particles per block

constexpr int kTableThreads = 256;     // table form: threads a block
constexpr int kTableItems = 512;       // 16-byte stores a K1 / K7 block aims at
constexpr int kGradItems = 1024;       // and a K4 block (lighter stores)
constexpr int kTableBlocks = 2 * 132;  // blocks a launch aims at (2 an SM)
constexpr int kTableSmem = 48 * 1024;  // no opt-in needed up to here
constexpr int kCodeBits = 8;           // bits of a table offset in a code
constexpr int kMaxOffsets = 1 << kCodeBits;

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

// Row-major R(q) entry e (math/quaternions.py::quat_to_rmat)
__device__ __forceinline__ float rmat_entry(const float* q, int e) {
  const float q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const float a0 = __fmul_rn(q0, q0), a1 = __fmul_rn(q1, q1);
  const float a2 = __fmul_rn(q2, q2), a3 = __fmul_rn(q3, q3);
  switch (e) {
    case 0: return __fsub_rn(__fsub_rn(__fadd_rn(a0, a1), a2), a3);
    case 1: return 2.0f * __fsub_rn(__fmul_rn(q1, q2), __fmul_rn(q0, q3));
    case 2: return 2.0f * __fadd_rn(__fmul_rn(q1, q3), __fmul_rn(q0, q2));
    case 3: return 2.0f * __fadd_rn(__fmul_rn(q1, q2), __fmul_rn(q0, q3));
    case 4: return __fsub_rn(__fadd_rn(__fsub_rn(a0, a1), a2), a3);
    case 5: return 2.0f * __fsub_rn(__fmul_rn(q2, q3), __fmul_rn(q0, q1));
    case 6: return 2.0f * __fsub_rn(__fmul_rn(q1, q3), __fmul_rn(q0, q2));
    case 7: return 2.0f * __fadd_rn(__fmul_rn(q2, q3), __fmul_rn(q0, q1));
    default: return __fadd_rn(__fsub_rn(__fsub_rn(a0, a1), a2), a3);
  }
}

// ---------------------------------------------------------------- planner

int basis_smem(bool jac, int usum, int per_block) {
  return per_block * (8 * usum + (jac ? 36 : 0));
}

// Particles of K4 whose flat rows [d, m] together fill whole 16-byte
// stores: a block takes a multiple of them, so its range starts aligned.
inline int grad_period(int dm) { return dm % 4 == 0 ? 1 : dm % 2 == 0 ? 2 : 4; }

// The form of K4 (jac false) or K1 / K7 (jac true, `item`-byte outputs)
// and the particles a block takes: 1 the table form, 0 the direct form
// (per_block 0), where the distinct values of all dimensions pass 256 (a
// table offset is a byte) or the particles make fewer than
// kTableBlocks blocks. Mirrored by kernels/basis_eval.py::_basis_plan.
int basis_plan(bool jac, long long n, int d, int m, int nl_pad, int item,
               const int* u, int* per_block) {
  int usum = 0, umin = kMaxOffsets;
  for (int j = 0; j < d; ++j) {
    usum += u[j];
    umin = u[j] < umin ? u[j] : umin;
  }
  *per_block = 0;
  if (umin < 1 || usum > kMaxOffsets) return 0;
  const int g = jac ? 1 : grad_period(d * m);
  // too few particles to fill the card: the table form's extra phase
  // would only add to the launch's latency
  if ((n + g - 1) / g < kTableBlocks) return 0;
  int per = jac ? kTableItems / ((nl_pad * item + 15) / 16)
                : 4 * kGradItems / (d * m);
  per = per < g ? g : per - per % g;
  while (per > g && (n + per - 1) / per < kTableBlocks) per -= g;
  while (per > g && basis_smem(jac, usum, per) > kTableSmem) per -= g;
  if (basis_smem(jac, usum, per) > kTableSmem) return 0;
  *per_block = per;
  return 1;
}

struct TableArgs {
  const float* table;  // [3 d, ustride]: freq, phase, fac rows per dimension
  const int* codes;    // K1 / K7: per output column; K4: per flat position
  int ustride;
  int u[3];            // distinct values per dimension
  int per_block;       // particles a block
  int period;          // K4: particles the position codes cover
};

// Byte f of a code: a table offset
__device__ __forceinline__ unsigned field(unsigned code, int f) {
  return __byte_perm(code, 0, 0x4440 + f);
}

// Loads from a shared-memory address (32 bits), so that an entry's address
// is one shift-add of its offset to the particle's table
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds2(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

// --------------------------------------------------------------- phase 1

// tab[pl * usum + off_j + u] = (sin a, fac * cos a) of dimension j's
// distinct value u at the block's particle pl (np of them)
template <int D>
__device__ __forceinline__ void fill_table(const float* __restrict__ x,
                                           const TableArgs& ta, long long p0,
                                           int np, float2* tab) {
  int usum = 0;
#pragma unroll
  for (int j = 0; j < D; ++j) usum += ta.u[j];
  const int off1 = ta.u[0], off2 = ta.u[0] + (D > 1 ? ta.u[1] : 0);
  for (int w = threadIdx.x; w < np * usum; w += blockDim.x) {
    const int pl = w / usum;
    const int v = w - pl * usum;
    const int j = (D > 1 && v >= off1) + (D > 2 && v >= off2);
    const float* t = ta.table + (v - (j == 0 ? 0 : j == 1 ? off1 : off2));
    const float a = phase(x[(p0 + pl) * D + j], __ldg(t + j * ta.ustride),
                          __ldg(t + (D + j) * ta.ustride));
    float s, c;
    sincosf(a, &s, &c);
    tab[w] = make_float2(s, __fmul_rn(__ldg(t + (2 * D + j) * ta.ustride), c));
  }
}

// ------------------------------------------------------------ K4, table

// Position code of flat element (q, i, b) of a period: fields 0-2 the
// table offsets of fac * cos of dimension i, then of the sines of the
// other dimensions in order; byte 3 the particle q in the period.
template <int D>
__global__ void __launch_bounds__(kTableThreads)
grad_table_kernel(const float* __restrict__ x, TableArgs ta, float scale,
                  float* __restrict__ out, long long n, int m) {
  extern __shared__ float2 tab[];
  int usum = 0;
#pragma unroll
  for (int j = 0; j < D; ++j) usum += ta.u[j];
  const long long p0 = (long long)blockIdx.x * ta.per_block;
  const int np = (int)min((long long)ta.per_block, n - p0);
  fill_table<D>(x, ta, p0, np, tab);
  __syncthreads();

  // the block's flat range [np, D, m], four floats a thread at a time;
  // t counts periods, r is the position in the period
  const unsigned tab_a = smem_address(tab);
  const int gdm = ta.period * D * m;
  const int total = np * D * m;
  const int stride = 4 * (int)blockDim.x;
  const int step_t = stride / gdm, step_r = stride - step_t * gdm;
  int e = 4 * (int)threadIdx.x;
  int t = e / gdm, r = e - t * gdm;
  float* dst = out + p0 * D * m;
  for (; e < total; e += stride) {
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(ta.codes + r));
    const unsigned codes[4] = {(unsigned)c4.x, (unsigned)c4.y,
                               (unsigned)c4.z, (unsigned)c4.w};
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned code = codes[c];
      const unsigned tp = tab_a + 8 * (t * ta.period + (code >> 24)) * usum;
      float prod = lds(tp + 8 * field(code, 0) + 4);
#pragma unroll
      for (int f = 1; f < D; ++f) prod = __fmul_rn(prod, lds(tp + 8 * field(code, f)));
      v[c] = __fmul_rn(scale, prod);
    }
    if (e + 4 <= total) {
      *reinterpret_cast<float4*>(dst + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (e + c < total) dst[e + c] = v[c];
      }
    }
    r += step_r;
    t += step_t;
    if (r >= gdm) {
      r -= gdm;
      ++t;
    }
  }
}

// ------------------------------------------------------- K1 / K7, table

template <typename OutT>
__device__ __forceinline__ void store16(OutT* dst, const float* v);
template <>
__device__ __forceinline__ void store16<float>(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float* v) {
  // one paired conversion (cvt.rn.bf16x2.f32) rounds each half to
  // nearest even, as __float2bfloat16_rn does
  __nv_bfloat162 w[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) w[h] = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(w);
}

// Column c of C: R(q)^T grad phi at the column whose code is `code`
template <int V>
__device__ __forceinline__ void jac_column(unsigned tp, unsigned code,
                                           const float* R, float scale,
                                           float (&C)[3][V], int c) {
  float s[3], fc[3], g[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float2 te = lds2(tp + 8 * field(code, j));
    s[j] = te.x;
    fc[j] = te.y;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float prod = fc[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j != i) prod = __fmul_rn(prod, s[j]);
    }
    g[i] = __fmul_rn(scale, prod);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    C[k][c] = __fadd_rn(__fadd_rn(__fmul_rn(R[k], g[0]), __fmul_rn(R[3 + k], g[1])),
                        __fmul_rn(R[6 + k], g[2]));
  }
}

// K1 (rows layout [N, 3, nl_pad]) and K7 (kTransposed: [3, N, nl_pad]).
// Column code of output column col (3 <= col < 3 + m): field j the table
// offset of dimension j's value at basis function col - 3.
template <typename OutT, bool kTransposed>
__global__ void __launch_bounds__(kTableThreads)
jac_table_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                 TableArgs ta, float scale, OutT* __restrict__ out,
                 long long n, int m, int nl_pad) {
  constexpr int V = 16 / sizeof(OutT);  // columns a 16-byte store
  extern __shared__ float2 tab[];
  const int usum = ta.u[0] + ta.u[1] + ta.u[2];
  float* Rs = reinterpret_cast<float*>(tab + ta.per_block * usum);
  const long long p0 = (long long)blockIdx.x * ta.per_block;
  const int np = (int)min((long long)ta.per_block, n - p0);
  fill_table<3>(pos, ta, p0, np, tab);
  for (int w = threadIdx.x; w < 9 * np; w += blockDim.x) {
    const int pl = w / 9;
    Rs[w] = rmat_entry(quat + (p0 + pl) * 4, w - 9 * pl);
  }
  __syncthreads();

  const int chunks = (nl_pad + V - 1) / V;
  const bool vec = nl_pad % V == 0;
  for (int w = threadIdx.x; w < np * chunks; w += blockDim.x) {
    const int pl = w / chunks;
    const int col0 = (w - pl * chunks) * V;
    const unsigned tp = smem_address(tab + pl * usum);
    const float* Rp = Rs + pl * 9;
    float R[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = Rp[e];
    unsigned codes[V];
    if (col0 < 3 + m) {
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const int4 c4 = __ldg(reinterpret_cast<const int4*>(ta.codes + col0) + h);
        codes[4 * h] = c4.x;
        codes[4 * h + 1] = c4.y;
        codes[4 * h + 2] = c4.z;
        codes[4 * h + 3] = c4.w;
      }
    }
    float C[3][V];
    if (col0 >= 3 && col0 + V <= 3 + m) {
      // basis columns only (all but a row's first and last stores): no
      // branch, so the columns' table loads overlap
#pragma unroll
      for (int c = 0; c < V; ++c) jac_column(tp, codes[c], R, scale, C, c);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int col = col0 + c;
        if (col < 3) {
          // identity block of the linear kernel: C[k, col] = R[col, k]
#pragma unroll
          for (int k = 0; k < 3; ++k) C[k][c] = Rp[col * 3 + k];
        } else if (col < 3 + m) {
          jac_column(tp, codes[c], R, scale, C, c);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) C[k][c] = 0.0f;
        }
      }
    }
    const long long p = p0 + pl;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long long row = kTransposed ? (long long)k * n + p : p * 3 + k;
      OutT* dst = out + row * nl_pad + col0;
      if (vec) {
        store16<OutT>(dst, C[k]);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          if (col0 + c < nl_pad) dst[c] = from_float<OutT>(C[k][c]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ direct form

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

// K1 and K7 in the direct form; kTransposed selects the store index:
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
#pragma unroll
    for (int e = 0; e < 9; ++e) Rs[ty][e] = rmat_entry(quat + p * 4, e);
  }
  __syncthreads();
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (p >= n || col >= nl_pad) return;
  const float* R = Rs[ty];
  float C[3];
  if (col < 3) {
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

// ---------------------------------------------------------------- launch

// Check the caller's plan against basis_plan and fill the table arguments;
// *blocks is the table form's grid (0 for the direct form).
cudaError_t table_launch(bool jac, long long n, int d, int m, int nl_pad,
                         int item, const void* table, const void* codes,
                         int u0, int u1, int u2, int ustride, int form,
                         int per_block, TableArgs* ta, unsigned* blocks,
                         size_t* smem) {
  const int u[3] = {u0, d > 1 ? u1 : 0, d > 2 ? u2 : 0};
  int plan_per = 0;
  const int plan_form = basis_plan(jac, n, d, m, nl_pad, item, u, &plan_per);
  if (form != plan_form || per_block != plan_per) return cudaErrorInvalidValue;
  *blocks = 0;
  if (form == 0) return cudaSuccess;
  for (int j = 0; j < d; ++j) {
    if (u[j] > ustride) return cudaErrorInvalidValue;
  }
  const long long nb = (n + per_block - 1) / per_block;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  *ta = TableArgs{static_cast<const float*>(table),
                  static_cast<const int*>(codes), ustride, {u[0], u[1], u[2]},
                  per_block, jac ? 1 : grad_period(d * m)};
  *blocks = (unsigned)nb;
  *smem = (size_t)basis_smem(jac, u[0] + u[1] + u[2], per_block);
  return cudaSuccess;
}

}  // namespace

extern "C" int rbs_grad_basis(const void* x, const void* consts, float scale,
                              void* out, long long n, int m, int d,
                              const void* table, const void* codes, int u0,
                              int u1, int u2, int ustride, int form,
                              int per_block, void* stream) {
  if (d < 1 || d > 3) return (int)cudaErrorInvalidValue;
  TableArgs ta;
  unsigned blocks;
  size_t smem = 0;
  cudaError_t err = table_launch(false, n, d, m, 0, 4, table, codes, u0, u1,
                                 u2, ustride, form, per_block, &ta, &blocks,
                                 &smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (blocks > 0) {
    switch (d) {
      case 1: grad_table_kernel<1><<<blocks, kTableThreads, smem, s>>>(xf, ta, scale, of, n, m); break;
      case 2: grad_table_kernel<2><<<blocks, kTableThreads, smem, s>>>(xf, ta, scale, of, n, m); break;
      default: grad_table_kernel<3><<<blocks, kTableThreads, smem, s>>>(xf, ta, scale, of, n, m); break;
    }
    return (int)cudaGetLastError();
  }
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (m + kCols - 1) / kCols);
  const float* cf = static_cast<const float*>(consts);
  switch (d) {
    case 1: grad_basis_kernel<1><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    case 2: grad_basis_kernel<2><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
    default: grad_basis_kernel<3><<<grid, block, 0, s>>>(xf, cf, scale, of, n, m); break;
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

namespace {

template <typename OutT, bool kTransposed>
int launch_jac(const void* pos, const void* quat, const void* consts,
               const void* table, const void* codes, float scale, void* out,
               long long n, int m, int nl_pad, int u0, int u1, int u2,
               int ustride, int form, int per_block, void* stream) {
  TableArgs ta;
  unsigned blocks;
  size_t smem = 0;
  cudaError_t err = table_launch(true, n, 3, m, nl_pad, sizeof(OutT), table,
                                 codes, u0, u1, u2, ustride, form, per_block,
                                 &ta, &blocks, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(pos);
  const float* qf = static_cast<const float*>(quat);
  OutT* of = static_cast<OutT*>(out);
  if (blocks > 0) {
    jac_table_kernel<OutT, kTransposed><<<blocks, kTableThreads, smem, s>>>(
        pf, qf, ta, scale, of, n, m, nl_pad);
  } else {
    const dim3 block(kCols, kRows);
    const dim3 grid((unsigned)((n + kRows - 1) / kRows),
                    (nl_pad + kCols - 1) / kCols);
    jac3d_kernel<OutT, kTransposed><<<grid, block, 0, s>>>(
        pf, qf, static_cast<const float*>(consts), scale, of, n, m, nl_pad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rbs_jac3d_rows(const void* pos, const void* quat,
                              const void* consts, float scale, void* out,
                              long long n, int m, int nl_pad, int out_bf16,
                              const void* table, const void* codes, int u0,
                              int u1, int u2, int ustride, int form,
                              int per_block, void* stream) {
  return out_bf16
             ? launch_jac<__nv_bfloat16, false>(pos, quat, consts, table, codes,
                                                scale, out, n, m, nl_pad, u0,
                                                u1, u2, ustride, form,
                                                per_block, stream)
             : launch_jac<float, false>(pos, quat, consts, table, codes, scale,
                                        out, n, m, nl_pad, u0, u1, u2, ustride,
                                        form, per_block, stream);
}

extern "C" int rbs_jac3d(const void* pos, const void* quat, const void* consts,
                         float scale, void* out, long long n, int m,
                         int nl_pad, const void* table, const void* codes,
                         int u0, int u1, int u2, int ustride, int form,
                         int per_block, void* stream) {
  return launch_jac<float, true>(pos, quat, consts, table, codes, scale, out,
                                 n, m, nl_pad, u0, u1, u2, ustride, form,
                                 per_block, stream);
}
