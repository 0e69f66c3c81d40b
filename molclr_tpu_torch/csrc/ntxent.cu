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
// Bound on the H100: K2f is 2 n^2 d FP32 operations, K2b 4 n^2 d (0.13 and
// 0.26 ms at n = 4,096, d = 256, 67 TFLOP/s); the bytes (4 MB of reps) take
// about 1 us. Reps are f32 in every step, so the products are FP32 FMA on
// the CUDA cores (no TF32).
//
// Design. Both kernels cut s into 64 x 64 tiles: a block owns one 64-row
// tile and one column split, a contiguous run of column tiles that the
// caller plans (ops/ntxent.py ntxent_plan) so that (row tiles x splits)
// blocks fill the card at 2B = 1,024 as at 8,192, and this file only
// checks. A block streams its rows and its split's column tiles through a
// ring of cp.async stages, a chunk of d at a time (rows and columns both: a
// block's rows at d = 1,024 would take 256 KB), so shared memory stays 55
// KB (K2f: 3 stages of 32) and 85 KB (K2b: 2 stages of 64) for any d; four
// K2f and two K2b blocks share an SM. The next chunk is in flight while the
// current one is multiplied. The mainloop (chunk_scores, one device
// function for both kernels) gives each thread a TR x TC register tile and
// reads float4s along k from rows padded by 4 words (no bank conflicts):
// K2f's 8 x 8 tiles do 64 FMA for 4 float4 loads, so the loop is bound by
// FMA, not by shared loads; K2b's 4 x 4 tiles (its 256 threads also hold
// the [64, 256] output) 16 for 2. K2b's deeper chunks halve its barriers
// (0.72 -> 0.63 ms at n = 4,096, d = 256 on an H100; the same depth cost
// K2f a block per SM and 50 %). Each s_ij is one thread's sum over k
// ascending, the same bits in both kernels.
//   K2f: after each column tile, a row's online (m, l) is updated in tile
//   order; the 8 threads that share a row reduce with xor shuffles (the
//   same value on every lane). pos is one term: only the partner column
//   contributes. Each block writes its split's (m_s, l_s, pos_s) to a
//   [3, splits, n] scratch, and ntxent_merge_kernel combines the splits in
//   ascending order: m = max m_s, l = sum l_s exp(m_s - m), pos = sum pos_s.
//   A split whose columns are all dead has m_s = -1e30 and l_s = its column
//   count, so every merged (m, l) stays finite (K2b divides by l and
//   multiplies by valid: inf x 0 would be NaN).
//   K2b: the same grid, and a third dimension of 256-wide slices of d (one
//   for d <= 256; wider d recomputes s per slice). After a tile's s chunks,
//   each thread forms M = P + P^T for its 16 entries and writes M^T to
//   shared memory; the tile's columns then stream again, PC rows of the
//   slice at a time, through the same ring, and M @ cols accumulates into
//   an 8 x 8 register tile per thread ([64, 256] a block). Each block
//   writes its split's partial to [splits, n, d], and ntxent_sum_kernel
//   adds the splits in order and scales by 1/T once. No atomics: two runs
//   are bit-identical.

#include <cuda_runtime.h>
#include <math.h>

namespace ntx {

constexpr int RB = 64;                  // rows per block (a row tile)
constexpr int CB = 64;                  // columns per column tile
constexpr int KC = 32;                  // K2f: depth of an s chunk
constexpr int NS = 3;                   // K2f: ring stages
constexpr int BKC = 64;                 // K2b: depth of an s chunk
constexpr int BNS = 2;                  // K2b: ring stages
constexpr int DO = 256;                 // K2b: output columns per block
constexpr int PC = 32;                  // K2b: column rows per product chunk
constexpr int LDO = DO + 4;             // row stride of a product chunk
constexpr int LDM = RB + 4;             // row stride of M^T
constexpr int FWD_NT = 64;              // K2f threads: 8 x 8, 8 x 8 each
constexpr int BWD_NT = 256;             // K2b threads: 4 x 4 (s), 8 x 8 each
constexpr int STAGE = 2 * RB * (KC + 4);
constexpr int BSTAGE = 2 * RB * (BKC + 4) > PC * LDO ? 2 * RB * (BKC + 4)
                                                     : PC * LDO;
constexpr int FWD_SMEM = NS * STAGE * 4;
constexpr int BWD_SMEM = (BNS * BSTAGE + CB * LDM) * 4;
constexpr float NEG = -1e30f;

static_assert(RB == CB, "row and column tiles share the chunk loader");
static_assert(CB % PC == 0 && DO == 2 * 4 * 32, "product thread tiling");

__device__ __forceinline__ int partner_of(int i, int half) {
  return i < half ? i + half : i - half;
}

// Asynchronous copies global -> shared of 4 and 16 bytes; the first
// `bytes` are copied and the rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying reps[r0 .. r0 + rows, k0 .. k0 + width) into dst (row
// stride ld), zeros past column d. `wide` (d % 4 == 0): 16-byte copies.
template <int NT>
__device__ __forceinline__ void load_chunk(const float* reps, int d,
                                           bool wide, int r0, int rows,
                                           int k0, int width, float* dst,
                                           int ld) {
  if (wide) {
    const int per = width / 4;
    for (int e = threadIdx.x; e < rows * per; e += NT) {
      const int r = e / per, q = 4 * (e % per), k = k0 + q;
      const bool in = k < d;
      cp_async16(dst + r * ld + q, reps + (size_t)(r0 + r) * d + (in ? k : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += NT) {
      const int r = e / width, q = e % width, k = k0 + q;
      const bool in = k < d;
      cp_async4(dst + r * ld + q, reps + (size_t)(r0 + r) * d + (in ? k : 0),
                in ? 4 : 0);
    }
  }
}

// The mainloop's step: s[i][j] += R[ty + GY i] . C[tx + GX j] over one
// chunk of depth K, k ascending; Rs and Cs are [64][K + 4] chunks of the
// stage.
template <int TR, int TC, int K>
__device__ __forceinline__ void chunk_scores(const float* Rs, const float* Cs,
                                             int ty, int tx,
                                             float (&s)[TR][TC]) {
  constexpr int GY = RB / TR, GX = CB / TC, LDK = K + 4;
#pragma unroll
  for (int kk = 0; kk < K; kk += 4) {
    float4 b[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j)
      b[j] = *reinterpret_cast<const float4*>(Cs + (tx + GX * j) * LDK + kk);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(Rs + (ty + GY * i) * LDK + kk);
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
}

// max / sum over the 8 lanes that share a row (xor butterfly: every lane
// gets the same value)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The split's column tiles [t0, t1) of block (row tile, split).
__device__ __forceinline__ void split_tiles(int n, int tps, int& t0,
                                            int& t1) {
  t0 = blockIdx.y * tps;
  t1 = min(t0 + tps, n / CB);
}

__global__ void __launch_bounds__(FWD_NT, 4)
ntxent_fwd_kernel(const float* __restrict__ reps,
                  const float* __restrict__ valid, float inv_t, int n, int d,
                  int tps, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int row0 = blockIdx.x * RB, half = n / 2;
  int t0, t1;
  split_tiles(n, tps, t0, t1);
  const int nk = (d + KC - 1) / KC, total = (t1 - t0) * nk;
  const bool wide = (d & 3) == 0;
  auto fetch = [&](int q) {
    float* st = smem + (q % NS) * STAGE;
    const int k0 = (q % nk) * KC;
    load_chunk<FWD_NT>(reps, d, wide, row0, RB, k0, KC, st, KC + 4);
    load_chunk<FWD_NT>(reps, d, wide, (t0 + q / nk) * CB, CB, k0, KC,
                       st + RB * (KC + 4), KC + 4);
  };
#pragma unroll
  for (int q = 0; q < NS - 1; ++q) {
    if (q < total) fetch(q);
    cp_async_commit();
  }
  float m[8], l[8], pos[8], s[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = NEG, l[i] = 0.f, pos[i] = 0.f;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // chunk q has landed; stage (q - 1) % NS is consumed
    if (q + NS - 1 < total) fetch(q + NS - 1);
    cp_async_commit();
    const int kc = q % nk;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    const float* st = smem + (q % NS) * STAGE;
    chunk_scores<8, 8, KC>(st, st + RB * (KC + 4), ty, tx, s);
    if (kc != nk - 1) continue;
    // the tile is complete: mask it and update the online statistics
    const int c0 = (t0 + q / nk) * CB;
    bool dead_col[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dead_col[j] = valid[c0 + tx + 8 * j] == 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty + 8 * i, partner = partner_of(row, half);
      float v[8], mx = NEG, p = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 8 * j;
        v[j] = (col == row || dead_col[j]) ? NEG : __fmul_rn(s[i][j], inv_t);
        if (col == partner) p = v[j];
        mx = fmaxf(mx, v[j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) e += expf(v[j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(e);
      m[i] = m_new;
      pos[i] += row_sum(p);
    }
  }
  if (tx == 0) {
    const size_t plane = (size_t)gridDim.y * n, off = (size_t)blockIdx.y * n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty + 8 * i;
      part[off + row] = m[i];
      part[plane + off + row] = l[i];
      part[2 * plane + off + row] = pos[i];
    }
  }
}

// Combine the splits' (m_s, l_s, pos_s) of each row, in split order.
__global__ void ntxent_merge_kernel(const float* __restrict__ part, int n,
                                    int splits, float* __restrict__ m,
                                    float* __restrict__ l,
                                    float* __restrict__ pos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t plane = (size_t)splits * n;
  float mx = NEG;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[(size_t)s * n + i]);
  float sl = 0.f, sp = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = (size_t)s * n + i;
    sl += part[plane + at] * expf(part[at] - mx);
    sp += part[2 * plane + at];
  }
  m[i] = mx;
  l[i] = sl;
  pos[i] = sp;
}

__global__ void __launch_bounds__(BWD_NT, 2)
ntxent_bwd_kernel(const float* __restrict__ reps,
                  const float* __restrict__ valid, float inv_t,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, int n, int d, int tps,
                  float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Mt = smem + BNS * BSTAGE;  // [CB][LDM]: M^T of the current tile
  // a warp is 4 x 8 threads in both phases, so that each float4 load
  // touches at most 128 bytes: s rows sy + 16 i, columns sx + 16 j (4 x 4);
  // product rows 8 py + i, output columns kz + 4 px + 128 h + e (8 x 8)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sy = (lane >> 3) + 4 * (warp >> 1);
  const int sx = (lane & 7) + 8 * (warp & 1);
  const int py = (lane >> 3) + 4 * (warp & 1);
  const int px = (lane & 7) + 8 * (warp >> 1);
  const int row0 = blockIdx.x * RB, half = n / 2, kz = blockIdx.z * DO;
  int t0, t1;
  split_tiles(n, tps, t0, t1);
  const int nk = (d + BKC - 1) / BKC, per = nk + CB / PC;
  const int total = (t1 - t0) * per;
  const bool wide = (d & 3) == 0;
  const float scale = *scale_p;
  auto fetch = [&](int q) {
    float* st = smem + (q % BNS) * BSTAGE;
    const int c0 = (t0 + q / per) * CB, u = q % per;
    if (u < nk) {
      load_chunk<BWD_NT>(reps, d, wide, row0, RB, u * BKC, BKC, st, BKC + 4);
      load_chunk<BWD_NT>(reps, d, wide, c0, CB, u * BKC, BKC,
                         st + RB * (BKC + 4), BKC + 4);
    } else {
      load_chunk<BWD_NT>(reps, d, wide, c0 + (u - nk) * PC, PC, kz, DO, st,
                         LDO);
    }
  };
#pragma unroll
  for (int q = 0; q < BNS - 1; ++q) {
    if (q < total) fetch(q);
    cp_async_commit();
  }
  float acc[8][8], s[4][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int q = 0; q < total; ++q) {
    cp_async_wait<BNS - 2>();
    __syncthreads();  // chunk q (and M^T, after a tile's last s chunk) ready
    if (q + BNS - 1 < total) fetch(q + BNS - 1);
    cp_async_commit();
    const float* st = smem + (q % BNS) * BSTAGE;
    const int u = q % per;
    if (u < nk) {
      if (u == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      chunk_scores<4, 4, BKC>(st, st + RB * (BKC + 4), sy, sx, s);
      if (u != nk - 1) continue;
      // M = P + P^T for this thread's 16 entries of the tile, as M^T
      const int c0 = (t0 + q / per) * CB;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + sx + 16 * j, col_partner = partner_of(col, half);
        const float m_c = m_in[col], l_c = l_in[col], v_c = valid[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + sy + 16 * i;
          const float m_r = m_in[row], l_r = l_in[row], v_r = valid[row];
          const bool diag = col == row;
          const float sij = __fmul_rn(s[i][j], inv_t);
          // P for my rows: dead columns are padded or the diagonal
          const float s_mine = (diag || v_c == 0.f) ? NEG : sij;
          float p = expf(s_mine - m_r) / l_r;
          p -= col == partner_of(row, half) ? 1.f : 0.f;
          p *= scale * v_r;
          // P^T: the column rows' softmax at my rows, dead where my row is
          // padding
          const float s_theirs = (diag || v_r == 0.f) ? NEG : sij;
          float pt = expf(s_theirs - m_c) / l_c;
          pt -= col_partner == row ? 1.f : 0.f;
          pt *= scale * v_c;
          Mt[(sx + 16 * j) * LDM + sy + 16 * i] = p + pt;
        }
      }
    } else {
      // acc[8 py + i][kz + 4 px + 128 h + e] += M[., c] * cols[c, .] over
      // this chunk's PC column rows, c ascending
      const float* Mc = Mt + (u - nk) * PC * LDM + 8 * py;
#pragma unroll 4
      for (int c = 0; c < PC; ++c) {
        const float4 a0 = *reinterpret_cast<const float4*>(Mc + c * LDM);
        const float4 a1 = *reinterpret_cast<const float4*>(Mc + c * LDM + 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(st + c * LDO + 4 * px);
        const float4 b1 =
            *reinterpret_cast<const float4*>(st + c * LDO + 4 * px + 128);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  float* out = part + (size_t)blockIdx.y * n * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = row0 + 8 * py + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kz + 4 * px + 128 * h;
      if (wide) {
        if (k < d)
          *reinterpret_cast<float4*>(out + row * d + k) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < d) out[row * d + k + e] = acc[i][4 * h + e];
      }
    }
  }
}

// dreps = (sum over splits, in order, of part[s]) / T, four values a
// thread (n d is a multiple of 4: n is of 128).
__global__ void ntxent_sum_kernel(const float4* __restrict__ part,
                                  float4* __restrict__ dreps, int splits,
                                  int width4, float inv_t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width4) return;
  float4 t = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 v = part[(size_t)s * width4 + i];
    t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
  }
  dreps[i] = make_float4(__fmul_rn(t.x, inv_t), __fmul_rn(t.y, inv_t),
                         __fmul_rn(t.z, inv_t), __fmul_rn(t.w, inv_t));
}

// The caller's plan: 2B a multiple of 128, d >= 1, and `splits` runs of
// `tps` column tiles that cover the n / CB tiles with none empty; `smem`
// is the kernel's shared memory as the caller computed it.
static bool plan_ok(int n, int d, int splits, int tps, int smem, int want) {
  if (n <= 0 || n % (2 * RB) || d <= 0 || splits <= 0 || tps <= 0)
    return false;
  const long tiles = n / CB;
  return (long)(splits - 1) * tps < tiles && tiles <= (long)splits * tps &&
         smem == want;
}

// Allow `bytes` of dynamic shared memory with the largest carveout, once
// per device.
static cudaError_t allow_smem(const void* kernel, int bytes,
                              unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

}  // namespace ntx

extern "C" {

// K2f: part is [3, splits, n] scratch; m, l, pos [n].
int ntxent_fwd(const float* reps, const float* valid, float inv_t, float* m,
               float* l, float* pos, float* part, int n, int d, int splits,
               int tps, int smem, void* stream) {
  if (!ntx::plan_ok(n, d, splits, tps, smem, ntx::FWD_SMEM))
    return (int)cudaErrorInvalidValue;
  static unsigned long long done = 0;
  cudaError_t e =
      ntx::allow_smem((const void*)ntx::ntxent_fwd_kernel, smem, done);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  ntx::ntxent_fwd_kernel<<<dim3(n / ntx::RB, splits), ntx::FWD_NT, smem,
                           st>>>(reps, valid, inv_t, n, d, tps, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ntx::ntxent_merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, n, splits,
                                                           m, l, pos);
  return (int)cudaGetLastError();
}

// K2b: part is [splits, n, d] scratch; dreps [n, d].
int ntxent_bwd(const float* reps, const float* valid, float inv_t,
               const float* scale, const float* m, const float* l,
               float* dreps, float* part, int n, int d, int splits, int tps,
               int smem, void* stream) {
  if (!ntx::plan_ok(n, d, splits, tps, smem, ntx::BWD_SMEM))
    return (int)cudaErrorInvalidValue;
  static unsigned long long done = 0;
  cudaError_t e =
      ntx::allow_smem((const void*)ntx::ntxent_bwd_kernel, smem, done);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n / ntx::RB, splits, (d + ntx::DO - 1) / ntx::DO);
  ntx::ntxent_bwd_kernel<<<grid, ntx::BWD_NT, smem, st>>>(
      reps, valid, inv_t, scale, m, l, n, d, tps, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int width4 = n / 4 * d;
  ntx::ntxent_sum_kernel<<<(width4 + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dreps),
      splits, width4, inv_t);
  return (int)cudaGetLastError();
}

}  // extern "C"
