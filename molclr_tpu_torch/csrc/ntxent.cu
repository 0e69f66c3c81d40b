// K2f and K2b: the masked NT-Xent loss, flash-style, for sm_90a.
//
// Replace molclr_tpu/ops/pallas_ntxent.py:_fwd_kernel and _bwd_kernel (the
// Pallas TPU kernels behind nt_xent_pallas). On pre-normalized
// representations reps [n = 2B, d] (f32) with a 0/1 validity per row and
// partner(i) = i +- B:
//   s_ij = (reps_i . reps_j) / T, dead (-1e30) where j == i or valid_j == 0
//   K2f: per row the online max m_i, sum-exp l_i = sum_j exp(s_ij - m_i)
//        and the positive logit pos_i = s_i,partner(i)
//   K2b: dreps = (P + P^T) @ reps / T with
//        P_ij  = valid_i * scale * (exp(s_ij - m_i) / l_i - [j = partner(i)])
//        P^T   evaluated from the column rows' saved (m_j, l_j), dead where
//              row i is padding; scale = 1 / n_valid
// The [n, n] similarity matrix never reaches device memory.
//
// Design: one block of 256 threads (16 x 16, each a 4 x 4 sub-tile of a
// 64 x 64 block of s) per 64-row block. The block keeps its rows and one
// 64-row column block in shared memory (2 x 64 x 257 floats, padded
// against bank conflicts) and sweeps the column blocks in order, so each
// row's running (m, l) is updated in a fixed order. The row max and sum of
// a 64-column block reduce across the 16 threads of a half-warp with
// shuffles. K2b recomputes each s block, forms P + P^T for its own rows in
// shared memory and accumulates (P + P^T) @ cols into registers
// (4 rows x d/16 columns per thread): every output row is owned by one
// block, so no cross-block reduction is needed and two runs are
// bit-identical.
//
// Bound on the H100 at the pretraining shape (n = 1,024, d = 256, f32): K2f
// is 2 n^2 d = 0.54 GFLOP (8 us at 67 TFLOP/s), K2b 4 n^2 d = 1.07 GFLOP
// (16 us); the bytes (1 MB of reps) take under 1 us. Only n / 64 = 16
// blocks run at that shape, so the card is mostly idle; at n = 4,096 there
// are 64. No tensor cores yet (the products are f32 FMA from shared
// memory), and each block holds 132-148 KB of shared memory, one per SM.

#include <cuda_runtime.h>
#include <math.h>

namespace ntx {

constexpr int BLK = 64;       // rows per block, columns per sweep step
constexpr int NTH = 256;      // threads: tx = tid % 16, ty = tid / 16
constexpr int QMAX = 16;      // K2b: d / 16 output columns per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ int partner_of(int i, int half) {
  return i < half ? i + half : i - half;
}

// Copy rows [r0, r0 + BLK) of reps [n, d] into S [BLK, d + 1].
__device__ void load_rows(const float* reps, int r0, int d, float* S) {
  const int ld = d + 1;
  for (int e = threadIdx.x; e < BLK * d; e += NTH) {
    const int r = e / d, k = e % d;
    S[r * ld + k] = reps[(size_t)(r0 + r) * d + k];
  }
}

// s[i][j] = (R[ty + 16 i] . C[tx + 16 j]) * inv_t for this thread's 4 x 4.
__device__ void block_scores(const float* Rs, const float* Cs, int d,
                             float inv_t, float (&s)[4][4]) {
  const int ld = d + 1, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k = 0; k < d; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = Rs[(ty + 16 * i) * ld + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Cs[(tx + 16 * j) * ld + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(s[i][j], inv_t);
}

// max / sum over the 16 threads of a half-warp (the 64 columns of a row)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NTH)
ntxent_fwd_kernel(const float* __restrict__ reps,
                  const float* __restrict__ valid, float inv_t, int n, int d,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ pos_out) {
  extern __shared__ float smem[];
  const int ld = d + 1, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* Rs = smem;                // [BLK, ld] my rows
  float* Cs = Rs + BLK * ld;       // [BLK, ld] the current column block
  const int row0 = blockIdx.x * BLK, half = n / 2;
  load_rows(reps, row0, d, Rs);
  float m[4], l[4], pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = NEG, l[i] = 0.f, pos[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += BLK) {
    __syncthreads();               // the previous column block is consumed
    load_rows(reps, j0, d, Cs);
    __syncthreads();
    float s[4][4];
    block_scores(Rs, Cs, d, inv_t, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i, partner = partner_of(row, half);
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tx + 16 * j;
        if (col == row || valid[col] == 0.f) s[i][j] = NEG;
        if (col == partner) p += s[i][j];
      }
      const float m_new = fmaxf(m[i], half_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                                     fmaxf(s[i][2], s[i][3]))));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_sum(e);
      m[i] = m_new;
      pos[i] += half_sum(p);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      m_out[row] = m[i];
      l_out[row] = l[i];
      pos_out[row] = pos[i];
    }
  }
}

__global__ void __launch_bounds__(NTH)
ntxent_bwd_kernel(const float* __restrict__ reps,
                  const float* __restrict__ valid, float inv_t,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, int n, int d,
                  float* __restrict__ dreps) {
  extern __shared__ float smem[];
  const int ld = d + 1, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* Rs = smem;                // [BLK, ld]
  float* Cs = Rs + BLK * ld;       // [BLK, ld]
  float* Ps = Cs + BLK * ld;       // [BLK, BLK + 1]  P + P^T for my rows
  const int row0 = blockIdx.x * BLK, half = n / 2;
  const float scale = *scale_p;
  load_rows(reps, row0, d, Rs);
  float m_r[4], l_r[4], v_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    m_r[i] = m_in[row], l_r[i] = l_in[row], v_r[i] = valid[row];
  }
  float acc[4][QMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < QMAX; ++q) acc[i][q] = 0.f;
  for (int j0 = 0; j0 < n; j0 += BLK) {
    __syncthreads();               // Cs and Ps of the previous step consumed
    load_rows(reps, j0, d, Cs);
    __syncthreads();
    float s[4][4];
    block_scores(Rs, Cs, d, inv_t, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      const float m_c = m_in[col], l_c = l_in[col], v_c = valid[col];
      const int col_partner = partner_of(col, half);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty + 16 * i;
        const bool diag = col == row;
        // P for my rows: dead columns are padded or the diagonal
        const float s_mine = (diag || v_c == 0.f) ? NEG : s[i][j];
        float p = expf(s_mine - m_r[i]) / l_r[i];
        p -= col == partner_of(row, half) ? 1.f : 0.f;
        p *= scale * v_r[i];
        // P^T: the column rows' softmax at my rows, dead where my row is
        // padding
        const float s_theirs = (diag || v_r[i] == 0.f) ? NEG : s[i][j];
        float pt = expf(s_theirs - m_c) / l_c;
        pt -= col_partner == row ? 1.f : 0.f;
        pt *= scale * v_c;
        Ps[(ty + 16 * i) * (BLK + 1) + tx + 16 * j] = p + pt;
      }
    }
    __syncthreads();
    for (int c = 0; c < BLK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BLK + 1) + c];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        const int k = tx + 16 * q;
        if (k < d) {
          const float cv = Cs[c * ld + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(pv[i], cv, acc[i][q]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = row0 + ty + 16 * i;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) {
      const int k = tx + 16 * q;
      if (k < d) dreps[row * d + k] = __fmul_rn(acc[i][q], inv_t);
    }
  }
}

static cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ntx

extern "C" {

int ntxent_fwd(const float* reps, const float* valid, float inv_t,
               float* m, float* l, float* pos, int n, int d, void* stream) {
  if (n <= 0 || n % ntx::BLK || d <= 0 || d > 16 * ntx::QMAX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * (size_t)ntx::BLK * (d + 1) * sizeof(float);
  cudaError_t e = ntx::set_smem((const void*)ntx::ntxent_fwd_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  ntx::ntxent_fwd_kernel<<<n / ntx::BLK, ntx::NTH, bytes,
                           (cudaStream_t)stream>>>(reps, valid, inv_t, n, d,
                                                   m, l, pos);
  return (int)cudaGetLastError();
}

int ntxent_bwd(const float* reps, const float* valid, float inv_t,
               const float* scale, const float* m, const float* l,
               float* dreps, int n, int d, void* stream) {
  if (n <= 0 || n % ntx::BLK || d <= 0 || d > 16 * ntx::QMAX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (2 * (size_t)ntx::BLK * (d + 1)
                        + (size_t)ntx::BLK * (ntx::BLK + 1)) * sizeof(float);
  cudaError_t e = ntx::set_smem((const void*)ntx::ntxent_bwd_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  ntx::ntxent_bwd_kernel<<<n / ntx::BLK, ntx::NTH, bytes,
                           (cudaStream_t)stream>>>(reps, valid, inv_t, scale,
                                                   m, l, n, d, dreps);
  return (int)cudaGetLastError();
}

}  // extern "C"
