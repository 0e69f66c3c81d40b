// K3f and K3b: the BN-chained fused GCN layer, forward and backward, and
// K5f and K5b: the unchained GCN layer of the fine-tuning trunk, for
// sm_90a. All four run on the row-block products of fused_bn_common.cuh
// (16-row strips, one block of 256 threads per (strip, 128-column slice),
// FP32 FMA in f32, mma.sync m16n8k16 tensor cores with f32 sums in bf16,
// all-zero 32-column adjacency chunks and dead strips skipped); K3f is K5f's
// two launches with a BatchNorm prologue and a moment epilogue, K3b K5b's
// launches with a gt pass before them and the prologue's adjoint as the
// strip pass's epilogue. rnd() is the cast to the activation type T (float
// or bf16), at the points where the Pallas kernels cast; every sum is f32.
//
// K3f replaces molclr_tpu/ops/fused_gcn.py:_bn_fwd_kernel (the Pallas TPU
// kernel behind fused_gcn_bn_layer). Per node row:
//   y   = rnd(relu?(x * a + b))                 prologue: previous BN affine
//   xw  = rnd(y @ W)
//   out = rnd(A @ xw + cnt @ etab + bias)       etab: column-broadcast scalars
//   sums += [sum m out, sum m out^2]            m = diag(A) > 0
// A @ xw needs xw for the whole tile before any strip can use it, so K3f
// is two launches on one stream and the fixed-order sum of the moments:
//   * the xw pass (k5f_xw_kernel with BN): the strip's x rows go through
//     the prologue as they are staged into the left operand, then are
//     multiplied by W through the weight ring into an [N, D] scratch. A
//     strip whose A rows are all zero writes zeros and no product: A is
//     symmetric, so a live row weighs such a row of xw by an exact zero;
//   * the adjacency pass (adj_pass_kernel with the counts): out = rnd([A
//     live chunks | cnt rows] @ [xw rows of their nodes ; etab] + bias)
//     and the strip's masked moment partials (BnMoments). A strip whose A
//     and cnt rows are all zero computes no product: its rows are rnd(bias)
//     and its partials 0;
//   * sum_partials over the N / 16 strips, in strip order.
// At the embed shape (T = 18 tiles of 256, D = 300) each launch runs 288
// strips x 3 slices = 864 blocks of 64 KB (two to an SM; the 32 KB ring
// where a wider layer does not fit).
//
// Bound on the H100 at the embed shape (f32): as a dense computation 1.58
// GFLOP (y@W 0.83, A@xw 0.71, cnt@etab 0.04); the work this batch needs is
// 0.43 GFLOP (y@W over the 2,358 real rows, the adjacency and counts by
// their nonzeros), against 16 MB moved (x, out 5.5 MB each, A 4.7 MB, W
// 0.36 MB). So it is bound by operations: 6.5 us at the 67 TFLOP/s f32
// rate without tensor cores, against 4.9 us for the bytes. In bf16: 0.4 us
// of operations at 989 TFLOP/s, 2.5 us for 8.2 MB. What holds it back: the
// f32 products of 16-row blocks are bound by shared-memory loads; xw
// round-trips device memory (L2) between the launches; each block scans
// its adjacency rows and builds its operand before the first product; no
// wgmma or TMA.
//
// K5f and K5b replace molclr_tpu/ops/fused_gcn.py:_fwd_kernel and
// _bwd_kernel, the unchained layer fused_gcn_layer of the fine-tuning
// trunk (the scalar edge term and the bias stay in PyTorch):
//   K5f: xw = rnd(x @ W), out = rnd(A @ xw) (xw rounded where the Pallas
//        kernel rounds it, never re-associated into (A @ x) @ W);
//   K5b: dxw = rnd(A @ g), dx = rnd(dxw @ W^T), dW = x^T @ dxw in f32. x is
//        the saved input; nothing else is recomputed.
// K5f is K3f's two launches without the prologue, the counts and the
// moments (the adjacency pass stores out = rnd(A @ xw)). K5b is four
// launches:
//   * W^T, transposed once;
//   * the strip pass (k5b_strip_kernel), one block per (16-row strip,
//     128-column slice of dx): the block multiplies only the live 32-column
//     chunks of its A strip (a strip's rows reach the one to three
//     molecules they belong to), keeps the strip's rounded dxw in shared
//     memory and writes its own slice of it, then multiplies that slice of
//     dx = dxw @ W^T (the cheap sparse A @ g is recomputed by each of a
//     strip's blocks). A strip with no live chunk has dxw = 0 and flags
//     itself dead. Its weight ring follows the grid (launch_strip_pass);
//   * wgrad_kernel for dW: row chunks (dw_chunks in ops/fused_gcn.py: at
//     least two blocks per SM) x 64 x 64 tiles, dead strips skipped;
//   * sum_partials over the chunks, in chunk order. No atomics.
// Bound on the H100 at the fine-tuning shape (T = 4, 619 real rows, D =
// 300, f32): K5f 0.11 GFLOP against 3.9 MB, 1.7 us by operations; K5b
// 0.22 GFLOP against 5.4 MB, 3.4 us. At this shape a launch is short and
// the card wide: what bounds both is how many blocks they keep busy and
// how long each waits on memory.
// Members: K5f and K5b take a stack of M layers that share the adjacency
// (the JAX package's vmapped pallas_call over a seed / target ensemble) as
// grid z (the weight pass's grid y): x, W, xw, out, g, W^T, dxw, dx, the
// strip flags, the chunk partials and dW are per member, N x D, D x D, ...
// elements apart, and member m's blocks do the one-layer launch's
// arithmetic, so one launch over M members equals M launches bit for bit.
//
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
// It runs as launches on one stream, each deterministic:
//   * the gt pass (gcn_bn_bwd_gt_kernel): gt, gtc and the strip's dbias
//     partial over every row, padding included (memory-bound and small);
//   * W^T, transposed once;
//   * K5b's strip pass on gtc with the prologue's adjoint as its epilogue
//     (BnAdjoint: dpre, dx, xc and the strip's [da | db] partials; a strip
//     with no live chunk runs it on dxc = 0, so dx keeps its signed zeros).
//     The strip's flag is 0 only when its A rows and its cnt rows are all
//     zero (gtc is not zero on padding rows);
//   * wgrad_kernel with dW = xc^T @ dxw and detab = cnt^T @ gtc in one
//     launch, strips whose flag is 0 skipped (f32: the first design's
//     chunks of at most 1,024 rows, ops/fused_gcn.py gcn_bn_bwd_weight_shape);
//   * sum_partials for dbias, [da | db] and [dW | detab], each in a fixed
//     order.
// No atomics: two runs are bit-identical. In f32 every sum keeps the first
// design's order (products over k ascending; the moment and [da | db]
// partials each group of four rows, then the groups; the weight pass's
// rows ascending in each chunk), and a skipped term is an exact zero, so
// K3f's and K3b's f32 results are bit-identical to the first design's
// (strip kernels of 4 x 4 FMA tiles on CUDA cores over a dense adjacency
// strip, and a weight pass over the same row chunks).
// Bound on the H100 at the pretraining shape (T = 22, 4,696 real rows of
// 5,632, D = 300, f32): dxw @ W^T and xc^T @ dxw over the real rows are
// 2 x 0.85 GFLOP, the adjacency and counts by their nonzeros a few
// hundredths more, against about 33 MB moved: about 26 us by operations.
// In bf16 the bytes set it. What holds it back: the f32 products of 16-row
// blocks are bound by shared-memory loads and cover the padded rows of live
// strips; gtc, dxw and xc round-trip device memory (L2) between the
// launches (the TPU kernel has the whole tile in VMEM); no wgmma or TMA.

#include "fused_bn_common.cuh"

namespace fbl {

// K3b's gt pass: gt = g + m (ds0 + 2 out ds1) for one strip, each operation
// rounded as the plain version rounds it; gtc = rnd(gt) to scratch and the
// strip's dbias partial sum gt (uncast) to partial[blockIdx.x, c]. Blocks
// of GT_NT threads, one per strip.
constexpr int GT_NT = 128;

template <typename T>
__global__ void __launch_bounds__(GT_NT)
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
  for (int c = threadIdx.x; c < D; c += GT_NT) {
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

// The xw pass of K5f and (BN) K3f, one block per (16-row strip, 128-column
// slice of xw): the strip's x rows (BN: y = rnd(relu?(x a + b))) as the
// operand, its slice of xw = rnd(operand @ W) with W through the weight
// ring. A strip whose A rows are all zero writes zeros and no product
// (see above); the zeros keep whatever the buffer held out of the live
// chunks that the strip's nodes share. Where the [16, D] operand does not
// fit in shared memory (f32 above about D = 3,000), it streams in K-chunks
// (STREAM: rb_pass_streamed, the prologue applied as each chunk is staged;
// ka columns at a time), each output still one thread's sum from 0 over k
// ascending.
template <typename T>
__host__ __device__ inline RbSmem k5f_xw_smem(int S, int D, int ring) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(R, D), 0, pass_bytes<T>(R, ring));
}

template <typename T, bool BN, bool MEM, bool STREAM = false>
__global__ void __launch_bounds__(RNT, 2)
k5f_xw_kernel(const T* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const T* __restrict__ adj,
              const T* __restrict__ w, T* __restrict__ xw, int S, int D,
              int relu_in, int ring, int ka) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  if constexpr (MEM) {  // member blockIdx.z (K5f)
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    x += z * N * D;
    w += z * D * D;
    xw += z * N * D;
  }
  const RbSmem L = k5f_xw_smem<T>(S, STREAM ? ka : D, ring);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* xa = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of xw
  if (adj_live_chunks(adj, row0, R, S, flags, node, width, msk) == 0) {
    for (int e = threadIdx.x; e < R * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D) st(xw, (row0 + r) * D + c, 0.f);
    }
    return;
  }
  if constexpr (STREAM) {
    if constexpr (BN)
      rb_pass_streamed<T, R, true>(
          ring, ka, xa, x, row0, R, D, cb, D, scratch, w, D,
          [=](int k, float v) {
            return rnd<T>(prologue(v, a[k], b[k], relu_in));
          });
    else
      rb_pass_streamed<T, R, true>(ring, ka, xa, x, row0, R, D, cb, D,
                                   scratch, w, D);
  } else {
    const int lda = a_lda(D);
    if constexpr (BN)
      rows_to_a<R>(xa, lda, x, row0, R, D, [=](int k, float v) {
        return rnd<T>(prologue(v, a[k], b[k], relu_in));
      });
    else
      rows_to_a<R>(xa, lda, x, row0, R, D);
    rb_pass_wr<T, R>(ring, xa, lda, D, cb, D, scratch, w, D);
  }
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) st(xw, (row0 + r) * D + c, scratch[r * CS + j]);
  }
}

// The xw pass over N rows of M members at the 64 KB f32 weight ring (the
// 32 KB one where shared memory does not fit), x streamed in K-chunks where
// neither holds [16, D] of it.
template <typename T, bool BN>
static int launch_xw_pass(const void* x, const float* a, const float* b,
                          const void* adj, const void* w, void* xw, int N,
                          int S, int D, int relu_in, cudaStream_t st,
                          int M = 1) {
  const RbShape sh = rb_stream(D, [&](int ka) {
    return rb_shape(R, 1, [&](int, int rg) {
      return k5f_xw_smem<T>(S, ka, rg).total;
    });
  });
  if (!sh.rb) return (int)cudaErrorInvalidValue;
  // (K3f launches one member; K5f's one-member instantiations compile
  // without the member offsets)
  const bool mem = !BN && M > 1;
  auto kernel = mem ? (sh.ka ? k5f_xw_kernel<T, BN, !BN, true>
                             : k5f_xw_kernel<T, BN, !BN>)
                    : (sh.ka ? k5f_xw_kernel<T, BN, false, true>
                             : k5f_xw_kernel<T, BN, false>);
  cudaError_t e = set_smem(kernel, sh.bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(N / R, (D + RCW - 1) / RCW, M), RNT, sh.bytes, st>>>(
      (const T*)x, a, b, (const T*)adj, (const T*)w, (T*)xw, S, D, relu_in,
      sh.ring, sh.ka);
  return (int)cudaGetLastError();
}

// K3f's adjacency epilogue: out = rnd(Cs + bias), and the strip's masked
// moment partials [sum m out, sum m out^2] of the cast out at row row0 /
// 16 of partial [N / 16, 2 D], each group of four rows summed, then the
// groups in order (the first design's order).
template <typename T>
struct BnMoments {
  static constexpr bool kMembers = false;
  const float* bias;
  T* out;
  float* partial;
  int D;
  __device__ void operator()(size_t row0, int c0, float* Cs,
                             const float* msk) const {
    const int tid = threadIdx.x;
    for (int e = tid; e < R * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) {
        const float v = rnd<T>(Cs[r * CS + j] + bias[c]);
        Cs[r * CS + j] = v;
        st(out, (row0 + r) * D + c, v);
      }
    }
    __syncthreads();
    const int c = c0 + tid;
    if (tid < RCW && c < D) {
      float t0 = 0.f, t1 = 0.f;
      for (int w = 0; w < 4; ++w) {
        float s0 = 0.f, s1 = 0.f;
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * w + i;
          const float v = Cs[r * CS + tid], ob = v * msk[r];
          s0 += ob;
          s1 += ob * v;
        }
        t0 += s0;
        t1 += s1;
      }
      float* prow = partial + (row0 / R) * 2 * D;
      prow[c] = t0;
      prow[D + c] = t1;
    }
  }
};

// K3f: the xw pass into the scratch xw, the adjacency pass with the counts
// and the moment epilogue, then the sum of the N / 16 strips' partials in
// strip order.
template <typename T>
static int gcn_bn_fwd(const void* x, const float* a, const float* b,
                      const void* adj, const void* cnt, const void* etab,
                      const void* w, const float* bias, void* xw, void* out,
                      float* partial, float* sums, int T_, int S, int D,
                      int relu_in, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = T_ * S;
  int err = launch_xw_pass<T, true>(x, a, b, adj, w, xw, N, S, D, relu_in,
                                    st);
  if (err) return err;
  err = launch_adj_pass<T>(xw, adj, BnMoments<T>{bias, (T*)out, partial, D},
                           N, S, D, st, cnt, etab);
  if (err) return err;
  return launch_sum_partials(partial, sums, N / R, 2 * D, st);
}

// K5f of M members: xw = rnd(x @ W) into the scratch xw, then out =
// rnd(A @ xw).
template <typename T>
static int gcn_fwd(const void* x, const void* adj, const void* w, void* xw,
                   void* out, int T_, int S, int D, int M, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = T_ * S;
  int err = launch_xw_pass<T, false>(x, nullptr, nullptr, adj, w, xw, N, S,
                                     D, 0, st, M);
  if (err) return err;
  if (M > 1)
    return launch_adj_pass<T>(xw, adj,
                              AdjStoreMembers<T>{(T*)out, D, (size_t)N * D},
                              N, S, D, st, nullptr, nullptr, M);
  return launch_adj_pass<T>(xw, adj, AdjStore<T>{(T*)out, D}, N, S, D, st);
}

// The strip pass of K5b and K3b: one block of RNT threads per (16-row
// strip, 128-column slice of dx). The block finds the live 32-column chunks
// of its A strip, computes dxw = rnd(A @ g) for its strip over those chunks
// only and for all D columns (the next product needs the whole row; every
// slice of the strip recomputes this cheap sparse product), keeps it in
// shared memory as the left operand and writes its own slice of it, then
// computes its slice of dx = dxw @ W^T (wt = W^T, transposed once) into Cs
// and calls epi(row0, c0, Cs, msk) (K5b: AdjStore, dx = rnd(Cs); K3b:
// BnAdjoint). A strip with no live chunk has dxw = 0: it writes zeros and
// runs the epilogue on Cs = 0. The slice-0 block writes the strip's flag
// for the weight pass: 0 when its A rows are all zero and (cnt not null)
// so are its cnt rows. Shared memory: the chunk list, the node mask, the A
// chunks [16, live * 32], the dxw operand [16, D] and the pass scratch.
// Where [16, D] of dxw does not fit beside the A chunks (f32 above about D
// = 3,000), the strip pass is two launches: k5b_strip_kernel with STREAM
// computes and writes only its own slice of dxw (and the strip's flag), and
// k5b_dx_kernel streams the strip's dxw rows from device memory in
// K-chunks for its slice of dx and calls the epilogue (a strip with no live
// chunk: dxw = 0, so Cs = 0 there too).
constexpr int K5B_RB = 16;

template <typename T>
__host__ __device__ inline RbSmem k5b_smem(int S, int D, int ring) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(K5B_RB, nch * ACW),
                 a_bytes<T>(K5B_RB, D), pass_bytes<T>(K5B_RB, ring));
}

template <typename T, typename Epi, bool STREAM = false>
__global__ void __launch_bounds__(RNT, 2)
k5b_strip_kernel(const T* __restrict__ g, const T* __restrict__ adj,
                 const T* __restrict__ cnt, const T* __restrict__ wt,
                 T* __restrict__ dxw, Epi epi, int* __restrict__ strip_live,
                 int S, int D, int ring) {
  constexpr int RB = K5B_RB;
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int cnt_live;
  if constexpr (Epi::kMembers) {  // member blockIdx.z (K5b)
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * RB;
    g += z * N * D;
    wt += z * D * D;
    dxw += z * N * D;
    strip_live += z * gridDim.x;
  }
  const RbSmem L = k5b_smem<T>(S, STREAM ? 0 : D, ring);
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
  const int cb = blockIdx.y * RCW;  // this block's slice of dx
  const bool clive = cnt && cnt_rows_live(cnt, row0, RB, &cnt_live);
  const int nlive = adj_live_chunks(adj, row0, RB, S, flags, node, width,
                                    msk);
  if (blockIdx.y == 0 && tid == 0) strip_live[blockIdx.x] = nlive > 0 || clive;
  if (nlive == 0) {
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = cb + j;
      if (c < D) st(dxw, (row0 + r) * D + c, 0.f);
      scratch[r * CS + j] = 0.f;
    }
    if (STREAM) return;
    __syncthreads();
    epi(row0, cb, scratch, msk);
    return;
  }
  if constexpr (STREAM) {  // this block's slice of dxw = rnd(A @ g)
    const int KL = nlive * ACW, lda1 = a_lda(KL);
    adj_operand<RB, T>(adj, nullptr, row0, RB, S, nlive, node, width, knode,
                       ext, lda1);
    rb_pass<T, RB>(
        ext, lda1, KL, cb, D, scratch,
        [&](int k, int c) -> T { return g[(size_t)knode[k] * D + c]; },
        IdentityFor());
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = cb + j;
      if (c < D) st(dxw, (row0 + r) * D + c, scratch[r * CS + j]);
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
  // this block's slice of dxw @ W^T
  rb_pass_wr<T, RB>(ring, da, lda2, D, cb, D, scratch, wt, D);
  epi(row0, cb, scratch, msk);
}

// The streamed strip pass's second launch: one block of RNT threads per
// (16-row strip, 128-column slice of dx) computes its slice of dx = dxw @
// W^T with the strip's dxw rows streamed from device memory in K-chunks
// (ka columns at a time, or held whole where ka = 0), then calls epi(row0,
// c0, Cs, msk) as k5b_strip_kernel does. Members as there.
template <typename T, typename Epi, bool STREAM>
__global__ void __launch_bounds__(RNT, 2)
k5b_dx_kernel(const T* __restrict__ dxw, const T* __restrict__ adj,
              const T* __restrict__ wt, Epi epi, int S, int D, int ring,
              int ka) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  if constexpr (Epi::kMembers) {  // member blockIdx.z (K5b)
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    wt += z * D * D;
    dxw += z * N * D;
  }
  const RbSmem L = row_operand_smem<T>(STREAM ? ka : D, ring);
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* da = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of dx
  if (threadIdx.x < R) {
    const size_t r = row0 + threadIdx.x;
    msk[threadIdx.x] = ld(adj, r * S + r % S) > 0.f ? 1.f : 0.f;
  }
  rb_pass_streamed<T, R, STREAM>(ring, ka, da, dxw, row0, R, D, cb, D,
                                 scratch, wt, D);
  epi(row0, cb, scratch, msk);
}

// The strip pass over N rows of M members. Its f32 weight ring: where the
// grid is at most two blocks per SM (one fine-tuning batch), the 96 KB
// one, a block alone on its SM with the deepest pipeline; else the ring
// that leaves room for two blocks on an SM (rb_shape_two), so that one
// block's adjacency scan and products overlap another's (the pretraining
// batches, the members of an ensemble). The ring sets no f32 sum's order.
// Where no ring holds [16, D] of dxw, the two streamed launches.
template <typename T, typename Epi>
static int launch_strip_pass(const void* g, const void* adj, const void* cnt,
                             const void* wt, void* dxw, const Epi& epi,
                             int* strip_live, int N, int S, int D,
                             cudaStream_t st, int M = 1) {
  const dim3 grid(N / K5B_RB, (D + RCW - 1) / RCW, M);
  auto bytes = [&](int, int ring) { return k5b_smem<T>(S, D, ring).total; };
  const RbShape sh = (int)(grid.x * grid.y * grid.z) <= 2 * sm_count()
                         ? rb_shape(K5B_RB, 0, bytes)
                         : rb_shape_two(bytes);
  cudaError_t e;
  if (sh.rb) {
    if ((e = set_smem(k5b_strip_kernel<T, Epi>, sh.bytes)) != cudaSuccess)
      return (int)e;
    k5b_strip_kernel<T, Epi><<<grid, RNT, sh.bytes, st>>>(
        (const T*)g, (const T*)adj, (const T*)cnt, (const T*)wt, (T*)dxw,
        epi, strip_live, S, D, sh.ring);
    return (int)cudaGetLastError();
  }
  const RbShape s1 = rb_shape(K5B_RB, 1, [&](int, int ring) {
    return k5b_smem<T>(S, 0, ring).total;
  });
  const RbShape s2 = rb_stream(D, [&](int ka) {
    return rb_shape_two([&](int, int rg) {
      return row_operand_smem<T>(ka, rg).total;
    });
  });
  if (!s1.rb || !s2.rb) return (int)cudaErrorInvalidValue;
  auto k1 = k5b_strip_kernel<T, Epi, true>;
  if ((e = set_smem(k1, s1.bytes)) != cudaSuccess) return (int)e;
  k1<<<grid, RNT, s1.bytes, st>>>((const T*)g, (const T*)adj, (const T*)cnt,
                                  (const T*)wt, (T*)dxw, epi, strip_live, S,
                                  D, s1.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  auto k2 = s2.ka ? k5b_dx_kernel<T, Epi, true> : k5b_dx_kernel<T, Epi, false>;
  if ((e = set_smem(k2, s2.bytes)) != cudaSuccess) return (int)e;
  k2<<<grid, RNT, s2.bytes, st>>>((const T*)dxw, (const T*)adj, (const T*)wt,
                                  epi, S, D, s2.ring, s2.ka);
  return (int)cudaGetLastError();
}

// K5b: W^T, the strip pass, the weight pass dW = x^T @ dxw (wgrad_kernel:
// `chunks` row chunks of rows_per_chunk rows, which the caller chooses
// (ops/fused_gcn.py dw_chunks) and launch_wgrad only checks; times the 64 x
// 64 tiles of dW; strips with strip_live = 0 skipped) and the sum of the
// chunk partials in chunk order.
// M members: every buffer but adj is a stack of M.
template <typename T>
static int gcn_bwd(const void* g, const void* x, const void* adj,
                   const void* w, void* wt, void* dxw, void* dx,
                   int* strip_live, float* part_w, float* dw, int T_, int S,
                   int D, int chunks, int rows_per_chunk, int M,
                   void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || chunks <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = T_ * S;
  const size_t nd = (size_t)N * D;
  int err = launch_transpose<T>(w, wt, D, D, st, M);
  if (err) return err;
  if (M > 1)
    err = launch_strip_pass<T>(g, adj, nullptr, wt, dxw,
                               AdjStoreMembers<T>{(T*)dx, D, nd}, strip_live,
                               N, S, D, st, M);
  else
    err = launch_strip_pass<T>(g, adj, nullptr, wt, dxw,
                               AdjStore<T>{(T*)dx, D}, strip_live, N, S, D,
                               st);
  if (err) return err;
  const WProb p = {x, dxw, D, D, 0, nd, nd};
  err = launch_wgrad<T>(&p, 1, strip_live, N, rows_per_chunk, chunks, WT,
                        part_w, D * D, st, M);
  if (err) return err;
  return launch_sum_partials(part_w, dw, chunks, D * D, st, M);
}

// K3b: the gt pass, W^T, the strip pass with the prologue's adjoint, the
// weight pass over dW and detab and the fixed-order sums. Scratch: wt [D,
// D], gtc, dxw, xc [N, D] (T), strip_live [N / 16] and the partials
// part_gt [N / 16, D], part_adj [N / 16, 2 D], part_w [chunks, D*D +
// CNT_PAD*D]. Outputs: dx [N, D] (T), dbias [D], sums_adj [2 D] = [da |
// db] and wgrad [D*D + CNT_PAD*D] = [dW | detab] (f32). The weight pass's
// chunks, rows per chunk and tile rows are the caller's (ops/fused_gcn.py
// gcn_bn_bwd_weight_shape; launch_wgrad checks them).
template <typename T>
static int gcn_bn_bwd(const void* g, const float* ds, const void* x,
                      const float* a, const float* b, const void* adj,
                      const void* cnt, const void* out, const void* w,
                      void* wt, void* gtc, void* dxw, void* xc,
                      int* strip_live, float* part_gt, float* part_adj,
                      float* part_w, void* dx, float* dbias, float* sums_adj,
                      float* wgrad, int T_, int S, int D, int relu_in,
                      int chunks, int rows_per_chunk, int tile_rows,
                      void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = T_ * S, nstrip = N / R;
  gcn_bn_bwd_gt_kernel<T><<<nstrip, GT_NT, 0, st>>>(
      (const T*)g, ds, (const T*)adj, (const T*)out, (T*)gtc, part_gt, S, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = launch_transpose<T>(w, wt, D, D, st))) return err;
  err = launch_strip_pass<T>(
      gtc, adj, cnt, wt, dxw,
      BnAdjoint<T>{(const T*)x, a, b, (T*)dx, (T*)xc, part_adj, D, relu_in},
      strip_live, N, S, D, st);
  if (err) return err;
  const int width = D * D + CNT_PAD * D;
  const WProb p[2] = {{xc, dxw, D, D, 0}, {cnt, gtc, CNT_PAD, D, D * D}};
  err = launch_wgrad<T>(p, 2, strip_live, N, rows_per_chunk, chunks,
                        tile_rows, part_w, width, st);
  if (err) return err;
  if ((err = launch_sum_partials(part_gt, dbias, nstrip, D, st))) return err;
  if ((err = launch_sum_partials(part_adj, sums_adj, nstrip, 2 * D, st)))
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
                       void* xw, void* out, int T_, int S, int D, int M,    \
                       void* stream) {                                      \
    return fbl::gcn_fwd<T>(x, adj, w, xw, out, T_, S, D, M, stream);        \
  }                                                                         \
  int gcn_bwd_##suffix(const void* g, const void* x, const void* adj,       \
                       const void* w, void* wt, void* dxw, void* dx,        \
                       int* strip_live, float* part_w, float* dw, int T_,   \
                       int S, int D, int chunks, int rows_per_chunk, int M, \
                       void* stream) {                                      \
    return fbl::gcn_bwd<T>(g, x, adj, w, wt, dxw, dx, strip_live, part_w,   \
                           dw, T_, S, D, chunks, rows_per_chunk, M,         \
                           stream);                                         \
  }                                                                         \
  int gcn_bn_bwd_##suffix(                                                  \
      const void* g, const float* ds, const void* x, const float* a,        \
      const float* b, const void* adj, const void* cnt, const void* out,    \
      const void* w, void* wt, void* gtc, void* dxw, void* xc,              \
      int* strip_live, float* part_gt, float* part_adj, float* part_w,      \
      void* dx, float* dbias, float* sums_adj, float* wgrad, int T_, int S, \
      int D, int relu_in, int chunks, int rows_per_chunk, int tile_rows,    \
      void* stream) {                                                       \
    return fbl::gcn_bn_bwd<T>(g, ds, x, a, b, adj, cnt, out, w, wt, gtc,    \
                              dxw, xc, strip_live, part_gt, part_adj,       \
                              part_w, dx, dbias, sums_adj, wgrad, T_, S, D, \
                              relu_in, chunks, rows_per_chunk, tile_rows,   \
                              stream);                                      \
  }

GCN_ENTRIES(f32, float)
GCN_ENTRIES(bf16, __nv_bfloat16)

}  // extern "C"
