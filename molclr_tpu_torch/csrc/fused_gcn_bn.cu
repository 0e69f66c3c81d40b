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
//   K5f: xw = rnd(x @ W), out = rnd(A @ xw) (xw rounded where the Pallas
//        kernel rounds it, never re-associated into (A @ x) @ W);
//   K5b: dxw = rnd(A @ g), dx = rnd(dxw @ W^T), dW = x^T @ dxw in f32. x is
//        the saved input; nothing else is recomputed.
// Bound on the H100 at the fine-tuning shape (T = 4, 619 real rows, D =
// 300, f32): K5f 0.11 GFLOP against 3.9 MB, 1.7 us by operations; K5b
// 0.22 GFLOP against 5.4 MB, 3.4 us. At this shape a launch is short and
// the card wide: what bounds both is how many blocks they keep busy and
// how long each waits on memory. K5f is two row-block launches on 16-row
// strips (k5f_xw_kernel, adj_pass_kernel), 64 strips x 3 column passes =
// 192 blocks each at T = 4, where the first design ran 64 strip blocks
// per pass on CUDA cores: the xw pass multiplies the strip's x rows by W
// through the 64 KB f32 weight ring (two blocks share an SM; the 32 KB
// one where a wider layer does not fit), a strip whose A rows are all
// zero (37.5 % at T = 4) writing zeros; the adjacency pass multiplies
// only the strip's live 32-column chunks of A (14.3 % of them) by xw's
// rows streamed through the same ring. In f32 each output is one thread's
// sum in ascending k, so the results are bit-identical to the first
// design's; bf16 runs mma.sync tensor cores. K5b's redesign (four
// launches):
//   * W^T, transposed once (1.3 us);
//   * k5b_strip_kernel, one block per (16-row strip, 128-column pass of
//     dx): 64 strips x 3 passes = 192 blocks at T = 4 (the strip pass of
//     the first design ran 64). Each block multiplies only the live
//     32-column chunks of its A strip (a strip's rows reach the one to
//     three molecules they belong to), keeps the strip's rounded dxw in
//     shared memory and writes its own column pass of it, then multiplies
//     that pass of dx = dxw @ W^T (FP32 FMA in f32, mma.sync in bf16; the
//     cheap sparse A @ g is recomputed by each of a strip's three blocks
//     rather than using 8-row strips, whose A scan and products would
//     halve the rows per W chunk). A strip with no live chunk writes zeros
//     and flags itself dead;
//   * wgrad_kernel for dW: 11 chunks of 96 rows x 25 tiles of 64 x 64 = 275
//     blocks (dw_chunks in ops/fused_gcn.py: at least 2 x 132), loads
//     staged a step ahead, dead strips skipped and dead chunks writing
//     zeros, tensor cores in bf16;
//   * sum_partials over the 11 chunks, in chunk order. No atomics.

// K3b replaces molclr_tpu/ops/fused_gcn.py:_bn_bwd_kernel, the backward of
// K3f. Given the output cotangents (g [N, D], dsums [2, D]), the saved
// input x, the forward's own output out and W:
//   gt    = g + m * (ds0 + 2 out ds1)          (f32; gtc = rnd(gt))
//   dxw   = rnd(A @ gtc)                        (A is symmetric)
//   dxc   = dxw @ W^T                           (f32, NOT rounded)
//   pre   = x a + b; dpre = relu_in ? [pre > 0] dxc : dxc
//   dx    = rnd(dpre * a); xc = rnd(relu?(pre)) (the forward's prologue)
//   da = sum dpre x, db = sum dpre, dbias = sum gt (uncast, every row),
//   dW = xc^T @ dxw, detab = cnt^T @ gtc        (all f32)
// As K1b, it runs as passes on one stream, each deterministic: (a) rows:
// gt, gtc and the strip's dbias partial; (b) adjacency: dxw, K5f's
// adjacency pass (adj_pass_kernel of fused_bn_common.cuh) on gtc; (c)
// rows with W^T (transposed once): dxc and the prologue adjoint, writing
// dx and xc and the strip's [da | db] partials; (d) weights: dW and
// detab as two transposed-left problems of one atb_kernel launch over fixed
// row chunks; then every partial is added in a fixed order (sum_partials).
// No atomics: two runs are bit-identical. Nothing of the forward but x and
// out is read back; xc is recomputed from x, a and b.
// Bound on the H100 at the pretraining shape (T = 22, 4,696 real rows of
// 5,632, D = 300, f32): dxw @ W^T and xc^T @ dxw over the real rows are
// 2 x 0.85 GFLOP, the adjacency and counts by their nonzeros a few
// hundredths more, against about 33 MB moved: about 26 us by operations.
// In bf16 the bytes set it. What the design leaves on the table is the
// first K5b design's: no tensor cores outside the adjacency pass, a weight
// pass of 180 blocks each summing 1,024 rows, and dxw, gtc and xc
// round-tripping device memory between the passes (the TPU kernel has the
// whole tile in VMEM).

#include "fused_bn_common.cuh"

namespace fbl {

// K3f's first pass: xw = rnd(prologue(x) @ W) for one 16-row strip.
template <typename T>
__global__ void __launch_bounds__(NT)
gcn_xw_kernel(const T* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const T* __restrict__ w,
              T* __restrict__ xw, int D, int relu_in) {
  extern __shared__ float smem[];
  float* ys = smem;                            // [R, D] prologue rows
  float* Bs = ys + R * D;                      // [KC, CW]
  const size_t row0 = (size_t)blockIdx.x * R;
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int c = e % D;
    ys[e] = rnd<T>(prologue(ld(x, row0 * D + e), a[c], b[c], relu_in));
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

// K3f's second pass: out = [A strip | cnt] @ [xw ; etab] + bias with the
// moment epilogue.
template <typename T>
__global__ void __launch_bounds__(NT)
gcn_adj_kernel(const T* __restrict__ xw, const T* __restrict__ adj,
               const T* __restrict__ cnt, const T* __restrict__ etab,
               const float* __restrict__ bias, T* __restrict__ out,
               float* __restrict__ partial, int S, int D) {
  extern __shared__ float smem[];
  const int strips = S / R;
  const int tile = blockIdx.x / strips, strip = blockIdx.x % strips;
  const int KA = S + CNT_PAD;
  const size_t node0 = (size_t)tile * S;
  const size_t row0 = node0 + (size_t)strip * R;
  float* ext = smem;                           // [R, KA] A strip | cnt
  float* Bs = ext + R * KA;                    // [KC, CW], epilogue scratch
  float* msk = Bs + KC * CW;                   // [R]

  load_adj_strip(adj, cnt, tile, strip, S, ext, msk);
  strip_gemm(
      ext, KA, KA, D, Bs,
      [&](int k, int c) -> T {
        return k < S ? xw[(node0 + k) * D + c] : etab[(size_t)(k - S) * D + c];
      },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        moment_epilogue<T>(c0, acc, bias, out, row0, D, msk, Bs, partial);
      });
}

// K3b pass (a): gt = g + m (ds0 + 2 out ds1) for one strip, each operation
// rounded as the plain version rounds it; gtc = rnd(gt) to scratch and the
// strip's dbias partial sum gt (uncast) to partial[blockIdx.x, c].
template <typename T>
__global__ void __launch_bounds__(NT)
gcn_bn_bwd_gt_kernel(const T* __restrict__ g, const float* __restrict__ ds,
                     const T* __restrict__ adj, const T* __restrict__ out,
                     T* __restrict__ gtc, float* __restrict__ partial, int S,
                     int D) {
  __shared__ float msk[R];
  const int strips = S / R;
  const int strip = blockIdx.x % strips;
  const size_t row0 = (size_t)blockIdx.x * R;
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    msk[r] = ld(adj, (row0 + r) * S + strip * R + r) > 0.f ? 1.f : 0.f;
  }
  __syncthreads();
  float* prow = partial + (size_t)blockIdx.x * D;
  for (int c = threadIdx.x; c < D; c += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) {
      const size_t i = (row0 + r) * D + c;
      const float t = __fadd_rn(ds[c], __fmul_rn(2.f * ld(out, i), ds[D + c]));
      const float gt = __fadd_rn(ld(g, i), msk[r] * t);
      s += gt;
      st(gtc, i, gt);
    }
    prow[c] = s;
  }
}

// K3b pass (c): dxc = dxw @ W^T for one strip (wt = W^T streams row by row),
// kept in f32, then the prologue adjoint: dx = rnd(dpre * a), the
// recomputed prologue output xc = rnd(relu?(x a + b)) for the weight pass,
// and the strip's [da | db] partials (sum dpre x, sum dpre).
template <typename T>
__global__ void __launch_bounds__(NT)
gcn_bn_bwd_rows_kernel(const T* __restrict__ dxw, const T* __restrict__ wt,
                       const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b, T* __restrict__ dx,
                       T* __restrict__ xc, float* __restrict__ partial, int D,
                       int relu_in) {
  extern __shared__ float smem[];
  float* ys = smem;                            // [R, D] dxw rows
  float* Bs = ys + R * D;                      // [KC, CW], epilogue scratch
  const size_t row0 = (size_t)blockIdx.x * R;
  for (int e = threadIdx.x; e < R * D; e += NT) ys[e] = ld(dxw, row0 * D + e);
  // strip_gemm's first __syncthreads orders these writes before the reads
  strip_gemm(
      ys, D, D, D, Bs,
      [&](int k, int c) -> T { return wt[(size_t)k * D + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        float s[2][TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const size_t r = row0 + warp * TM + i;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < D) {
              const float xf = ld(x, r * D + c);
              const float pre = prologue(xf, a[c], b[c], 0);
              const float dpre = (!relu_in || pre > 0.f) ? acc[i][j] : 0.f;
              st(dx, r * D + c, __fmul_rn(dpre, a[c]));
              st(xc, r * D + c, relu_in ? fmaxf(pre, 0.f) : pre);
              s[0][j] += dpre * xf;
              s[1][j] += dpre;
            }
          }
        }
        float* prow = partial + (size_t)blockIdx.x * 2 * D;
        float* const dst[2] = {prow, prow + D};
        colsum_epilogue<2>(c0, s, D, Bs, dst);
      });
}

// K5f's passes; the second is also K3b's, K4b's and K1b's adjacency pass.
//   k5f_xw_kernel, one block per (16-row strip, 128-column pass of xw):
//     the strip's x rows as the operand, its pass of xw = rnd(x @ W) with W
//     through the weight ring. A strip whose A rows are all zero writes
//     zeros and no product: A is symmetric, so a live row weighs such a
//     row of xw by an exact zero, and the zeros keep whatever the buffer
//     held out of the live chunks that the strip's nodes share.
//   adj_pass_kernel (fused_bn_common.cuh, shared with K4b and K1b), one
//     block per (16-row strip, 128-column pass): its pass of out = rnd(A @
//     xw) over the strip's live 32-column chunks only; a strip with none
//     writes zeros.
template <typename T>
__host__ __device__ inline RbSmem k5f_xw_smem(int S, int D, int ring) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(R, D), 0, pass_bytes<T>(R, ring));
}

template <typename T>
__global__ void __launch_bounds__(RNT, 2)
k5f_xw_kernel(const T* __restrict__ x, const T* __restrict__ adj,
              const T* __restrict__ w, T* __restrict__ xw, int S, int D,
              int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const RbSmem L = k5f_xw_smem<T>(S, D, ring);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* xa = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's pass of xw
  if (adj_live_chunks(adj, row0, R, S, flags, node, width, msk) == 0) {
    for (int e = threadIdx.x; e < R * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D) st(xw, (row0 + r) * D + c, 0.f);
    }
    return;
  }
  const int lda = a_lda(D);
  rows_to_a<R>(xa, lda, x, row0, R, D);
  rb_pass_wr<T, R>(ring, xa, lda, D, cb, D, scratch, w, D);
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) st(xw, (row0 + r) * D + c, scratch[r * CS + j]);
  }
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
  size_t bytes = ((size_t)R * D + KC * CW) * sizeof(float);
  cudaError_t e = set_smem(gcn_xw_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  gcn_xw_kernel<T><<<nrow_blk, NT, bytes, st>>>(
      (const T*)x, a, b, (const T*)w, (T*)xw, D, relu_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bytes = ((size_t)R * (S + CNT_PAD) + KC * CW + R) * sizeof(float);
  if ((e = set_smem(gcn_adj_kernel<T>, bytes)) != cudaSuccess) return (int)e;
  gcn_adj_kernel<T><<<nrow_blk, NT, bytes, st>>>(
      (const T*)xw, (const T*)adj, (const T*)cnt, (const T*)etab, bias,
      (T*)out, partial, S, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return launch_sum_partials(partial, sums, nrow_blk, 2 * D, st);
}

// K5f: xw = rnd(x @ W) into the scratch xw at the 64 KB f32 weight ring
// (the 32 KB one where shared memory does not fit), then out = rnd(A @ xw).
template <typename T>
static int gcn_fwd(const void* x, const void* adj, const void* w, void* xw,
                   void* out, int T_, int S, int D, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = T_ * S;
  const RbShape sh = rb_shape(R, 1, [&](int, int rg) {
    return k5f_xw_smem<T>(S, D, rg).total;
  });
  if (!sh.rb) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(k5f_xw_kernel<T>, sh.bytes);
  if (e != cudaSuccess) return (int)e;
  k5f_xw_kernel<T><<<dim3(N / R, (D + RCW - 1) / RCW), RNT, sh.bytes, st>>>(
      (const T*)x, (const T*)adj, (const T*)w, (T*)xw, S, D, sh.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return launch_adj_pass<T>(xw, adj, AdjStore<T>{(T*)out, D}, N, S, D, st);
}

// K5b's strip pass: one block of RNT threads per (16-row strip, 128-column
// pass of dx). The block finds the live 32-column chunks of its A strip,
// computes dxw = rnd(A @ g) for its strip over those chunks only and for all
// D columns (the next product needs the whole row; every column pass of the
// strip recomputes this cheap sparse product), keeps it in shared memory as
// the left operand and writes its own column pass of it, then computes its
// pass of dx = rnd(dxw @ W^T) (wt = W^T, transposed once). A strip with no
// live chunk has dxw = dx = 0: it writes zeros and records strip_live = 0
// for the weight pass. Shared memory: the chunk list, the node mask, the A
// chunks [16, live * 32], the dxw operand [16, D] and the pass scratch.
constexpr int K5B_RB = 16;

template <typename T>
__host__ __device__ inline RbSmem k5b_smem(int S, int D, int ring) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(K5B_RB, nch * ACW),
                 a_bytes<T>(K5B_RB, D), pass_bytes<T>(K5B_RB, ring));
}

template <typename T>
__global__ void __launch_bounds__(RNT)
k5b_strip_kernel(const T* __restrict__ g, const T* __restrict__ adj,
                 const T* __restrict__ wt, T* __restrict__ dxw,
                 T* __restrict__ dx, int* __restrict__ strip_live, int S,
                 int D, int ring) {
  constexpr int RB = K5B_RB;
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const RbSmem L = k5b_smem<T>(S, D, ring);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  int* knode = width + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* ext = reinterpret_cast<T*>(smem + L.op0);
  T* da = reinterpret_cast<T*>(smem + L.op1);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * RB;
  const int cb = blockIdx.y * RCW;  // this block's column pass of dx
  const int nlive = adj_live_chunks(adj, row0, RB, S, flags, node, width,
                                    msk);
  if (blockIdx.y == 0 && tid == 0) strip_live[blockIdx.x] = nlive > 0;
  if (nlive == 0) {
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D) {
        st(dxw, (row0 + r) * D + c, 0.f);
        st(dx, (row0 + r) * D + c, 0.f);
      }
    }
    return;
  }
  const int KL = nlive * ACW, lda1 = a_lda(KL), lda2 = a_lda(D);
  a_zero_cols<RB>(da, lda2, D, D);
  adj_operand<RB, T>(adj, nullptr, row0, RB, S, nlive, node, width, knode,
                     ext, lda1);
  // dxw = rnd(A @ g) over the live chunks
  for (int c0 = 0; c0 < D; c0 += RCW) {
    rb_pass<T, RB>(
        ext, lda1, KL, c0, D, scratch,
        [&](int k, int c) -> T { return g[(size_t)knode[k] * D + c]; },
        IdentityFor());
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) {
        const float v = rnd<T>(scratch[r * CS + j]);
        scratch[r * CS + j] = v;
        if (c0 == cb) st(dxw, (row0 + r) * D + c, v);
      }
    }
    __syncthreads();
    cs_to_a<RB>(da, lda2, c0, D, scratch);
  }
  // dx = rnd(dxw @ W^T), this block's column pass
  rb_pass_wr<T, RB>(ring, da, lda2, D, cb, D, scratch, wt, D);
  for (int e = tid; e < RB * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) st(dx, (row0 + r) * D + c, scratch[r * CS + j]);
  }
}

// K5b: W^T, the strip pass (the f32 weight ring 0 where it fits in shared
// memory, else ring 1), the weight pass dW = x^T @ dxw (wgrad_kernel:
// `chunks` row chunks of rows_per_chunk rows, which the caller chooses
// (ops/fused_gcn.py dw_chunks) and this only checks: a multiple of 16, at
// most WMAX_ROWS, covering the N rows once; times the 64 x 64 tiles of dW;
// strips with strip_live = 0 skipped) and the sum of the chunk partials in
// chunk order.
template <typename T>
static int gcn_bwd(const void* g, const void* x, const void* adj,
                   const void* w, void* wt, void* dxw, void* dx,
                   int* strip_live, float* part_w, float* dw, int T_, int S,
                   int D, int chunks, int rows_per_chunk, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = T_ * S;
  const RbShape sh = rb_shape(K5B_RB, 0, [&](int, int ring) {
    return k5b_smem<T>(S, D, ring).total;
  });
  if (!sh.rb) return (int)cudaErrorInvalidValue;
  int err = launch_transpose<T>(w, wt, D, D, st);
  if (err) return err;
  cudaError_t e = set_smem(k5b_strip_kernel<T>, sh.bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / K5B_RB, (D + RCW - 1) / RCW);
  k5b_strip_kernel<T><<<grid, RNT, sh.bytes, st>>>(
      (const T*)g, (const T*)adj, (const T*)wt, (T*)dxw, (T*)dx, strip_live,
      S, D, sh.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const WProb p = {x, dxw, D, D, 0};
  err = launch_wgrad<T>(&p, 1, strip_live, N, rows_per_chunk, chunks, WT,
                        part_w, D * D, st);
  if (err) return err;
  return launch_sum_partials(part_w, dw, chunks, D * D, st);
}

// K3b: passes (a)-(d) and the fixed-order sums. Scratch: wt [D, D], gtc,
// dxw, xc [N, D] (T) and the partials part_gt [nblk, D], part_adj [nblk,
// 2 D], part_w [chunks, D*D + CNT_PAD*D]. Outputs: dx [N, D] (T), dbias
// [D], sums_adj [2 D] = [da | db] and wgrad [D*D + CNT_PAD*D] = [dW |
// detab] (f32).
template <typename T>
static int gcn_bn_bwd(const void* g, const float* ds, const void* x,
                      const float* a, const float* b, const void* adj,
                      const void* cnt, const void* out, const void* w,
                      void* wt, void* gtc, void* dxw, void* xc,
                      float* part_gt, float* part_adj, float* part_w,
                      void* dx, float* dbias, float* sums_adj, float* wgrad,
                      int T_, int S, int D, int relu_in, int chunks,
                      void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = T_ * S / R;
  const int N = T_ * S;
  gcn_bn_bwd_gt_kernel<T><<<nblk, NT, 0, st>>>(
      (const T*)g, ds, (const T*)adj, (const T*)out, (T*)gtc, part_gt, S, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int err = launch_adj_pass<T>(gtc, adj, AdjStore<T>{(T*)dxw, D}, N, S, D,
                               st);
  if (err) return err;
  if ((err = launch_transpose<T>(w, wt, D, D, st))) return err;
  const size_t bytes = ((size_t)R * D + KC * CW) * sizeof(float);
  if ((e = set_smem(gcn_bn_bwd_rows_kernel<T>, bytes)) != cudaSuccess)
    return (int)e;
  gcn_bn_bwd_rows_kernel<T><<<nblk, NT, bytes, st>>>(
      (const T*)dxw, (const T*)wt, (const T*)x, a, b, (T*)dx, (T*)xc,
      part_adj, D, relu_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const AtB p_w = {xc, dxw, D, D, 0};
  const AtB p_et = {cnt, gtc, CNT_PAD, D, D * D};
  const int width = D * D + CNT_PAD * D;
  int rows_per_chunk = (N + chunks - 1) / chunks;
  rows_per_chunk = (rows_per_chunk + AKT - 1) / AKT * AKT;
  atb_kernel<T><<<chunks * (atb_tiles(p_w) + atb_tiles(p_et)), ANT, 0, st>>>(
      p_w, p_et, p_et, 2, N, rows_per_chunk, chunks, width, part_w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((err = launch_sum_partials(part_gt, dbias, nblk, D, st))) return err;
  if ((err = launch_sum_partials(part_adj, sums_adj, nblk, 2 * D, st)))
    return err;
  return launch_sum_partials(part_w, wgrad, chunks, width, st);
}

}  // namespace fbl

extern "C" {

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
                       int* strip_live, float* part_w, float* dw, int T_,   \
                       int S, int D, int chunks, int rows_per_chunk,        \
                       void* stream) {                                      \
    return fbl::gcn_bwd<T>(g, x, adj, w, wt, dxw, dx, strip_live, part_w,   \
                           dw, T_, S, D, chunks, rows_per_chunk, stream);   \
  }                                                                         \
  int gcn_bn_bwd_##suffix(                                                  \
      const void* g, const float* ds, const void* x, const float* a,        \
      const float* b, const void* adj, const void* cnt, const void* out,    \
      const void* w, void* wt, void* gtc, void* dxw, void* xc,              \
      float* part_gt, float* part_adj, float* part_w, void* dx,             \
      float* dbias, float* sums_adj, float* wgrad, int T_, int S, int D,    \
      int relu_in, int chunks, void* stream) {                              \
    return fbl::gcn_bn_bwd<T>(g, ds, x, a, b, adj, cnt, out, w, wt, gtc,    \
                              dxw, xc, part_gt, part_adj, part_w, dx,       \
                              dbias, sums_adj, wgrad, T_, S, D, relu_in,    \
                              chunks, stream);                              \
  }

GCN_ENTRIES(f32, float)
GCN_ENTRIES(bf16, __nv_bfloat16)

}  // extern "C"
