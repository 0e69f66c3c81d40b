// K3f: BN-chained fused GCN layer, forward, for sm_90a.
//
// Replaces molclr_tpu/ops/fused_gcn.py:_bn_fwd_kernel (the Pallas TPU
// kernel behind fused_gcn_bn_layer). Per node row:
//   y   = rnd(relu?(x * a + b))                 prologue: previous BN affine
//   xw  = rnd(y @ W)
//   out = rnd(A @ xw + cnt @ etab + bias)       etab: column-broadcast scalars
//   sums += [sum m out, sum m out^2]            m = diag(A) > 0
// rnd() is the cast to the activation type T (float or bf16); every sum is
// f32.
//
// A @ xw needs xw for the WHOLE tile before any strip can use it, and a
// tile does not fit one block. So the layer runs as two passes on the same
// stream: gcn_xw_kernel computes xw = rnd(prologue(x) @ W) for 16-row
// strips into an [N, D] scratch buffer that the wrapper allocates, then
// gcn_bn_fwd_kernel computes out = [A strip | cnt] @ [xw tile ; etab] +
// bias with the moment epilogue, as K1f does (fused_bn_common.cuh), and
// sum_partials adds the per-block moments in block order. Shared memory at
// S = 256, D = 300: 35 KB for the first pass, 34 KB for the second.
//
// Bound on the H100 at the embed shape (T = 18 tiles of 256, D = 300,
// f32): as a dense computation 1.58 GFLOP (y@W 0.83, A@xw 0.71, cnt@etab
// 0.04); the work this batch needs is 0.43 GFLOP (y@W over the 2,358 real
// rows, the adjacency and counts by their nonzeros), against 16 MB moved
// (x, out 5.5 MB each, A 4.7 MB, W 0.36 MB). So it is bound by operations:
// 6.5 us at the 67 TFLOP/s f32 rate without tensor cores, against 4.9 us
// for the bytes. In bf16: 0.4 us of operations at 989 TFLOP/s, 2.5 us for
// 8.2 MB.
//
// What the simple design leaves on the table: no tensor cores (wgmma) and
// no TMA; xw makes a round trip through device memory (5.5 MB each way in
// f32); the dense A strip multiplies mostly zeros; W is re-read from L2 by
// each of the 288 first-pass blocks.

// K5f and K5b replace molclr_tpu/ops/fused_gcn.py:_fwd_kernel and
// _bwd_kernel, the unchained layer fused_gcn_layer of the fine-tuning
// trunk (the scalar edge term and the bias stay in PyTorch):
//   K5f: xw = rnd(x @ W), out = rnd(A @ xw): the two passes of K3f with
//        BN = false (no prologue; A @ xw alone, no cnt, etab, bias or
//        moments);
//   K5b: dxw = rnd(A @ g) (the adjacency pass on g), dx = rnd(dxw @ W^T)
//        (the row pass on dxw with W^T, transposed once so that it
//        streams row by row), dW = x^T @ dxw in f32 (atb_kernel over
//        fixed row chunks, summed in chunk order: no atomics). x is the
//        saved input; nothing else is recomputed.
// Bound on the H100 at the fine-tuning shape (T = 4, 619 real rows, D =
// 300, f32): K5f 0.11 GFLOP against 3.9 MB, 1.7 us by operations; K5b
// 0.22 GFLOP against 5.4 MB, 3.4 us. As for K4, 64 strip blocks leave
// most of the card idle and the launch costs about one block's latency.

#include "fused_bn_common.cuh"

namespace fbl {

// BN selects the kernel: true for K3f (prologue; [A | cnt] @ [xw ; etab] +
// bias with the moment epilogue), false for the unchained passes of K5f and
// K5b (no prologue; A @ xw alone, with no edge term, bias or moments).
template <typename T, bool BN>
__global__ void __launch_bounds__(NT)
gcn_xw_kernel(const T* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const T* __restrict__ w,
              T* __restrict__ xw, int D, int relu_in) {
  extern __shared__ float smem[];
  float* ys = smem;                            // [R, D] prologue rows
  float* Bs = ys + R * D;                      // [KC, CW]
  const size_t row0 = (size_t)blockIdx.x * R;
  for (int e = threadIdx.x; e < R * D; e += NT) {
    if constexpr (BN) {
      const int c = e % D;
      ys[e] = rnd<T>(prologue(ld(x, row0 * D + e), a[c], b[c], relu_in));
    } else {
      ys[e] = ld(x, row0 * D + e);
    }
  }
  // strip_gemm's first __syncthreads orders these writes before the reads
  strip_gemm(
      ys, D, D, D, Bs,
      [&](int k, int c) -> T { return w[(size_t)k * D + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < D) st(xw, (row0 + warp * TM + i) * D + c, acc[i][j]);
          }
      });
}

template <typename T, bool BN>
__global__ void __launch_bounds__(NT)
gcn_adj_kernel(const T* __restrict__ xw, const T* __restrict__ adj,
               const T* __restrict__ cnt, const T* __restrict__ etab,
               const float* __restrict__ bias, T* __restrict__ out,
               float* __restrict__ partial, int S, int D) {
  extern __shared__ float smem[];
  const int strips = S / R;
  const int tile = blockIdx.x / strips, strip = blockIdx.x % strips;
  const int KA = BN ? S + CNT_PAD : S;
  const size_t node0 = (size_t)tile * S;
  const size_t row0 = node0 + (size_t)strip * R;
  float* ext = smem;                           // [R, KA] A strip (| cnt)
  float* Bs = ext + R * KA;                    // [KC, CW], epilogue scratch
  float* msk = Bs + KC * CW;                   // [R]

  if constexpr (BN)
    load_adj_strip(adj, cnt, tile, strip, S, ext, msk);
  else
    load_a_strip(adj, tile, strip, S, ext, msk);
  strip_gemm(
      ext, KA, KA, D, Bs,
      [&](int k, int c) -> T {
        return k < S ? xw[(node0 + k) * D + c] : etab[(size_t)(k - S) * D + c];
      },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        if constexpr (BN) {
          moment_epilogue<T>(c0, acc, bias, out, row0, D, msk, Bs, partial);
        } else {
          const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int c = c0 + lane + 32 * j;
              if (c < D) st(out, (row0 + warp * TM + i) * D + c, acc[i][j]);
            }
        }
      });
}

template <typename T, bool BN>
static int launch_xw(const void* x, const float* a, const float* b,
                     const void* w, void* xw, int nrow_blk, int D,
                     int relu_in, cudaStream_t st) {
  const size_t bytes = ((size_t)R * D + KC * CW) * sizeof(float);
  cudaError_t e = set_smem(gcn_xw_kernel<T, BN>, bytes);
  if (e != cudaSuccess) return (int)e;
  gcn_xw_kernel<T, BN><<<nrow_blk, NT, bytes, st>>>(
      (const T*)x, a, b, (const T*)w, (T*)xw, D, relu_in);
  return (int)cudaGetLastError();
}

template <typename T, bool BN>
static int launch_adj(const void* xw, const void* adj, const void* cnt,
                      const void* etab, const float* bias, void* out,
                      float* partial, int nrow_blk, int S, int D,
                      cudaStream_t st) {
  const size_t bytes =
      ((size_t)R * (BN ? S + CNT_PAD : S) + KC * CW + R) * sizeof(float);
  cudaError_t e = set_smem(gcn_adj_kernel<T, BN>, bytes);
  if (e != cudaSuccess) return (int)e;
  gcn_adj_kernel<T, BN><<<nrow_blk, NT, bytes, st>>>(
      (const T*)xw, (const T*)adj, (const T*)cnt, (const T*)etab, bias,
      (T*)out, partial, S, D);
  return (int)cudaGetLastError();
}

template <typename T>
static int gcn_bn_fwd(const void* x, const float* a, const float* b,
                      const void* adj, const void* cnt, const void* etab,
                      const void* w, const float* bias, void* xw, void* out,
                      float* partial, float* sums, int T_, int S, int D,
                      int relu_in, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nrow_blk = T_ * S / R;
  int err = launch_xw<T, true>(x, a, b, w, xw, nrow_blk, D, relu_in, st);
  if (err) return err;
  err = launch_adj<T, true>(xw, adj, cnt, etab, bias, out, partial, nrow_blk,
                            S, D, st);
  if (err) return err;
  return launch_sum_partials(partial, sums, nrow_blk, 2 * D, st);
}

// K5f: xw = rnd(x @ W) into the scratch xw, then out = rnd(A @ xw).
template <typename T>
static int gcn_fwd(const void* x, const void* adj, const void* w, void* xw,
                   void* out, int T_, int S, int D, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nrow_blk = T_ * S / R;
  int err = launch_xw<T, false>(x, nullptr, nullptr, w, xw, nrow_blk, D, 0,
                                st);
  if (err) return err;
  return launch_adj<T, false>(xw, adj, nullptr, nullptr, nullptr, out,
                              nullptr, nrow_blk, S, D, st);
}

// K5b: dxw = rnd(A @ g) (A is symmetric: the adjoint of A @), dx = rnd(dxw
// @ W^T) with W^T transposed once into wt so that it streams row by row,
// and dW = x^T @ dxw in f32 from per-chunk partials added in chunk order.
template <typename T>
static int gcn_bwd(const void* g, const void* x, const void* adj,
                   const void* w, void* wt, void* dxw, void* dx,
                   float* part_w, float* dw, int T_, int S, int D, int chunks,
                   void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nrow_blk = T_ * S / R;
  const int N = T_ * S;
  int err = launch_adj<T, false>(g, adj, nullptr, nullptr, nullptr, dxw,
                                 nullptr, nrow_blk, S, D, st);
  if (err) return err;
  if ((err = launch_transpose<T>(w, wt, D, D, st))) return err;
  err = launch_xw<T, false>(dxw, nullptr, nullptr, wt, dx, nrow_blk, D, 0,
                            st);
  if (err) return err;
  const AtB p = {x, dxw, D, D, 0};
  int rows_per_chunk = (N + chunks - 1) / chunks;
  rows_per_chunk = (rows_per_chunk + AKT - 1) / AKT * AKT;
  atb_kernel<T><<<chunks * atb_tiles(p), ANT, 0, st>>>(
      p, p, p, 1, N, rows_per_chunk, chunks, D * D, part_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum_partials(part_w, dw, chunks, D * D, st);
}

}  // namespace fbl

extern "C" {

int fbl_strip_rows() { return fbl::R; }

#define GCN_ENTRIES(suffix, T)                                              \
  int gcn_bn_fwd_##suffix(const void* x, const float* a, const float* b,    \
                          const void* adj, const void* cnt,                 \
                          const void* etab, const void* w,                  \
                          const float* bias, void* xw, void* out,           \
                          float* partial, float* sums, int T_, int S,       \
                          int D, int relu_in, void* stream) {               \
    return fbl::gcn_bn_fwd<T>(x, a, b, adj, cnt, etab, w, bias, xw, out,    \
                              partial, sums, T_, S, D, relu_in, stream);    \
  }                                                                         \
  int gcn_fwd_##suffix(const void* x, const void* adj, const void* w,       \
                       void* xw, void* out, int T_, int S, int D,           \
                       void* stream) {                                      \
    return fbl::gcn_fwd<T>(x, adj, w, xw, out, T_, S, D, stream);           \
  }                                                                         \
  int gcn_bwd_##suffix(const void* g, const void* x, const void* adj,       \
                       const void* w, void* wt, void* dxw, void* dx,        \
                       float* part_w, float* dw, int T_, int S, int D,      \
                       int chunks, void* stream) {                          \
    return fbl::gcn_bwd<T>(g, x, adj, w, wt, dxw, dx, part_w, dw, T_, S, D, \
                           chunks, stream);                                 \
  }

GCN_ENTRIES(f32, float)
GCN_ENTRIES(bf16, __nv_bfloat16)

}  // extern "C"
