// Shared pieces of the BN-chained fused layer kernels (sm_90a).
//
// A TPU kernel of molclr_tpu/ops/fused_{layer,gcn}.py processes one whole
// 256-node tile per sequential grid step, with the tile's adjacency block
// and features resident in VMEM, and adds the masked output moments into
// one resident [2, D] block. On Hopper neither carries over: a tile's A
// (256 x 256) plus its features (256 x 300) do not fit a block's 227 KB of
// shared memory, and blocks run in parallel in no order. So here
//   * one block of 128 threads owns a STRIP of R = 16 rows of one tile
//     (T * S/R blocks; 288 at the embed shape, small enough in shared
//     memory that three run on each SM and all of them in one wave);
//   * its left operand ([A strip | cnt rows], then its own intermediates)
//     lives in shared memory as f32, and the right operand streams through
//     a [KC x CW] shared chunk, column pass by column pass; each thread
//     stages one column of the NEXT chunk in registers while the block
//     multiplies the current one, so the loads overlap the products;
//   * each block writes its masked moment partials to its own row of a
//     [n_blocks, 2, D] scratch, and sum_partials adds the rows in block
//     order: no atomics, so repeated runs are bit-identical.
// Products are plain f32 FMA loops (no tensor cores yet). Every value is
// rounded to the activation type T exactly where the Pallas kernels cast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace fbl {

constexpr int R = 16;        // rows per block (one strip of a tile)
constexpr int CW = 128;      // output columns per pass
constexpr int KC = 32;       // depth of one streamed right-operand chunk
constexpr int NT = 128;      // threads per block: 4 warps
constexpr int TM = 4;        // rows per thread: warp w owns rows 4w..4w+3
constexpr int TN = 4;        // columns per thread: lane + 32 j, j < 4
constexpr int NWARP = NT / 32;
constexpr int CNT_PAD = 16;  // cnt columns / etab rows (ops/fused_layer.py)
constexpr int RED = 2 * NWARP * CW;  // epilogue scratch, aliased on the chunk

static_assert(NWARP * TM == R && 32 * TN == CW, "thread tiling");
static_assert(NT == CW, "thread t stages column t of each chunk");
static_assert(RED <= KC * CW, "epilogue scratch fits in the chunk buffer");

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// an element of a right operand as f32
__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to the activation type and back (the Pallas casts)
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The BatchNorm prologue relu?(x * a + b), with the multiply and the add
// rounded separately as the plain PyTorch version does (no contraction).
__device__ __forceinline__ float prologue(float x, float a, float b,
                                          int relu_in) {
  float v = __fadd_rn(__fmul_rn(x, a), b);
  return relu_in ? fmaxf(v, 0.f) : v;
}

struct Identity {
  __device__ float operator()(int, int, float v) const { return v; }
};

// C[R, ncols] = As[R, K] @ B[K, ncols], As in shared memory (row stride
// lda). B element (k, c) is xf_b(k, c, tof(load_b(k, c))): load_b reads
// the raw element (float or bf16) from device memory one chunk ahead into
// registers, and nothing uses it until it is converted and transformed on
// its way to the shared chunk, so the loads stay in flight during the
// products. For each CW-wide column pass, epi(c0, acc) receives this
// thread's TM x TN accumulators: rows warp * TM + i, columns
// c0 + lane + 32 j (columns >= ncols hold garbage and must be skipped). A
// warp reads one As address at a time (broadcast) and 32 consecutive Bs
// words (no bank conflicts). All threads must call it; epi may call
// __syncthreads and may reuse Bs as scratch (after a __syncthreads).
template <typename LoadB, typename XfB, typename Epi>
__device__ void strip_gemm(const float* As, int lda, int K, int ncols,
                           float* Bs, LoadB load_b, XfB xf_b, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int c0 = 0; c0 < ncols; c0 += CW) {
    const int c = c0 + tid;  // the column this thread stages
    const bool cok = c < ncols;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    using V = decltype(load_b(0, 0));
    V stage[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      stage[kk] = (cok && kk < K) ? load_b(kk, c) : V();
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // the previous chunk (or epilogue scratch) is consumed
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const int k = k0 + kk;
        Bs[kk * CW + tid] = (cok && k < K) ? xf_b(k, c, tof(stage[kk])) : 0.f;
      }
      __syncthreads();
      const int k1 = k0 + KC;
      if (k1 < K) {  // next chunk's loads, in flight during the products
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          stage[kk] = (cok && k1 + kk < K) ? load_b(k1 + kk, c) : V();
      }
      const int kn = min(KC, K - k0);
      const float* arow = As + (size_t)warp * TM * lda + k0;
      for (int kk = 0; kk < kn; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = arow[i * lda + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * CW + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    epi(c0, acc);
  }
  __syncthreads();
}

// Load this block's [A strip | cnt rows] ([R, S + CNT_PAD], f32) into ext
// and the node mask diag(A) > 0 of its rows into msk. Real nodes always
// carry the slot-0 self-loop and padded rows are all-zero, so the diagonal
// IS the node mask (molclr_tpu/ops/fused_layer.py _adj_diag_mask).
template <typename T>
__device__ void load_adj_strip(const T* adj, const T* cnt, int tile,
                               int strip, int S, float* ext, float* msk) {
  const int KA = S + CNT_PAD;
  const size_t arow0 = ((size_t)tile * S + (size_t)strip * R) * S;
  const size_t crow0 = ((size_t)tile * S + (size_t)strip * R) * CNT_PAD;
  for (int e = threadIdx.x; e < R * KA; e += NT) {
    const int r = e / KA, k = e % KA;
    ext[e] = k < S ? ld(adj, arow0 + (size_t)r * S + k)
                   : ld(cnt, crow0 + (size_t)r * CNT_PAD + (k - S));
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    msk[r] = ext[r * KA + strip * R + r] > 0.f ? 1.f : 0.f;
  }
  // msk is read only after strip_gemm's next __syncthreads
}

// Load this block's A strip ([R, S], f32) into As and the node mask
// diag(A) > 0 of its rows into msk (load_adj_strip without the cnt rows).
template <typename T>
__device__ void load_a_strip(const T* adj, int tile, int strip, int S,
                             float* As, float* msk) {
  const size_t arow0 = ((size_t)tile * S + (size_t)strip * R) * S;
  for (int e = threadIdx.x; e < R * S; e += NT) As[e] = ld(adj, arow0 + e);
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    msk[r] = As[r * S + strip * R + r] > 0.f ? 1.f : 0.f;
  }
  // msk is read only after strip_gemm's next __syncthreads
}

// Column sums of a column pass over the strip's rows: s[v][j] is this
// thread's sum over its TM rows of quantity v at column c0 + lane + 32 j.
// The warps' sums meet in red[NV, NWARP, CW] (the chunk buffer, free once
// every warp is past its products) and are added in warp order into
// dst[v][c0 + tid] for c0 + tid < ncols. Called by all threads inside a
// strip_gemm epilogue.
template <int NV>
__device__ void colsum_epilogue(int c0, const float (&s)[NV][TN], int ncols,
                                float* red, float* const (&dst)[NV]) {
  static_assert(NV * NWARP * CW <= KC * CW, "scratch fits the chunk buffer");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __syncthreads();  // every warp is done reading the chunk that red reuses
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      red[(v * NWARP + warp) * CW + lane + 32 * j] = s[v][j];
  __syncthreads();
  if (tid < CW && c0 + tid < ncols) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float t = 0.f;
      for (int w = 0; w < NWARP; ++w) t += red[(v * NWARP + w) * CW + tid];
      dst[v][c0 + tid] = t;
    }
  }
  // red is overwritten only after strip_gemm's next __syncthreads
}

// Column-pass epilogue shared by both layers: v = rnd(acc + bias[c]) is
// written to out rows row0.., and the masked moments (sum m v, sum m v^2)
// of the CAST values over this strip go to partial[blockIdx.x, {0,1}, c].
template <typename T>
__device__ void moment_epilogue(int c0, const float (&acc)[TM][TN],
                                const float* bias, T* out, size_t row0,
                                int D, const float* msk, float* red,
                                float* partial) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[2][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = warp * TM + i;
    const float m = msk[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < D) {
        const float v = rnd<T>(acc[i][j] + bias[c]);
        st(out, (row0 + r) * D + c, v);
        const float ob = v * m;
        s[0][j] += ob;
        s[1][j] += ob * v;
      }
    }
  }
  float* prow = partial + (size_t)blockIdx.x * 2 * D;
  float* const dst[2] = {prow, prow + D};
  colsum_epilogue<2>(c0, s, D, red, dst);
}

// Weight-gradient products C[m, c] = sum_r X[r, m] * Y[r, c] over the rows
// r of a [N, M] and a [N, C] matrix (the transposed-left products of a
// backward pass). The row range splits into `chunks` fixed chunks; block
// (chunk, 64 x 64 output tile) writes its chunk's sums to
// partial[chunk, off + m * C + c], and sum_partials adds the chunks in
// order: no atomics, and each output tile's work is one block's. Up to
// three problems share one launch so that together they fill the card.
struct AtB {
  const void* x;  // [N, M]
  const void* y;  // [N, C]
  int m, c;       // output shape
  int off;        // offset of this problem's output in a partial row
};

constexpr int AT = 64;    // output tile edge
constexpr int AKT = 16;   // rows per staged chunk
constexpr int ANT = 256;  // threads: 16 x 16, each a 4 x 4 sub-tile

__host__ __device__ inline int atb_tiles(const AtB& p) {
  return ((p.m + AT - 1) / AT) * ((p.c + AT - 1) / AT);
}

template <typename T>
__global__ void __launch_bounds__(ANT)
atb_kernel(AtB p0, AtB p1, AtB p2, int nprob, int N, int rows_per_chunk,
           int chunks, int width, float* __restrict__ partial) {
  __shared__ float Xs[AKT][AT];
  __shared__ float Ys[AKT][AT];
  int blk = blockIdx.x;
  AtB p = p0;
  const AtB ps[3] = {p0, p1, p2};
  int q = 0;
  for (; q < nprob; ++q) {
    const int nb = chunks * atb_tiles(ps[q]);
    if (blk < nb) break;
    blk -= nb;
  }
  if (q >= nprob) return;
  p = ps[q];
  const int tiles_c = (p.c + AT - 1) / AT;
  const int chunk = blk / atb_tiles(p);
  const int t = blk % atb_tiles(p);
  const int m0 = (t / tiles_c) * AT, c0 = (t % tiles_c) * AT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* X = (const T*)p.x;
  const T* Y = (const T*)p.y;
  const int r_lo = chunk * rows_per_chunk;
  const int r_hi = min(N, r_lo + rows_per_chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = r_lo; r0 < r_hi; r0 += AKT) {
    for (int e = tid; e < AKT * AT; e += ANT) {
      const int kk = e / AT, mm = e % AT, r = r0 + kk;
      Xs[kk][mm] = (r < r_hi && m0 + mm < p.m)
                       ? ld(X, (size_t)r * p.m + m0 + mm) : 0.f;
      Ys[kk][mm] = (r < r_hi && c0 + mm < p.c)
                       ? ld(Y, (size_t)r * p.c + c0 + mm) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AKT; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* prow = partial + (size_t)chunk * width + p.off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (m < p.m && c < p.c) prow[(size_t)m * p.c + c] = acc[i][j];
    }
}

// dst [cols, rows] = src [rows, cols]^T through a 32 x 32 shared tile
// (blocks of 32 x 8 threads).
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ src,
                                 T* __restrict__ dst, int rows, int cols) {
  __shared__ float tile[32][33];
  int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 32 + threadIdx.y;
  for (int j = 0; j < 32; j += 8)
    if (x < cols && y + j < rows)
      tile[threadIdx.y + j][threadIdx.x] = ld(src, (size_t)(y + j) * cols + x);
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x, y = blockIdx.x * 32 + threadIdx.y;
  for (int j = 0; j < 32; j += 8)
    if (x < rows && y + j < cols)
      st(dst, (size_t)(y + j) * rows + x, tile[threadIdx.x][threadIdx.y + j]);
}

template <typename T>
static inline int launch_transpose(const void* src, void* dst, int rows,
                                   int cols, cudaStream_t stream) {
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  transpose_kernel<T><<<grid, block, 0, stream>>>((const T*)src, (T*)dst,
                                                   rows, cols);
  return (int)cudaGetLastError();
}

// Ask for the largest shared-memory carveout, so that three blocks of the
// size the kernels use fit on one SM, and allow `bytes` of dynamic shared
// memory.
template <typename Kernel>
static inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// sums[i] = sum over blocks, in block order, of partial[blk, i]; i < width.
static __global__ void sum_partials(const float* __restrict__ partial,
                                    float* __restrict__ sums, int nblk,
                                    int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float t = 0.f;
  for (int blk = 0; blk < nblk; ++blk) t += partial[(size_t)blk * width + i];
  sums[i] = t;
}

static inline int launch_sum_partials(const float* partial, float* sums,
                                      int nblk, int width,
                                      cudaStream_t stream) {
  sum_partials<<<(width + 255) / 256, 256, 0, stream>>>(partial, sums, nblk,
                                                         width);
  return (int)cudaGetLastError();
}

}  // namespace fbl
