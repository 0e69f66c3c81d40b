// K1b and K4b: the backward of the fused GINE layers, BN-chained (K1b,
// the backward of K1f) and unchained (K4b, K4f's), for sm_90a; their
// forwards are in fused_gine_bn.cu.
//
// K1b replaces molclr_tpu/ops/fused_layer.py:_bn_bwd_kernel. Given the
// output cotangents (g [N, D], dsums [2, D]) and the residuals:
//   gt    = g + m * (ds0 + 2 out ds1)   (f32; gtc = rnd(gt))
//   dmid  = (gtc @ W2^T) * [mid > 0]    (dmidc = rnd(dmid))
//   dagg  = dmidc @ W1^T                (daggc = rnd(dagg))
//   dx    = A @ daggc                   (A is symmetric: the adjoint of A@)
//   dpre  = dx * [h a + b > 0 if relu_in]
//   dh    = rnd(dpre * a)
//   da = sum dpre h, db = sum dpre, db1 = sum dmid, db2 = sum gt,
//   dW1 = agg^T dmidc, dW2 = mid^T gtc, detab = cnt^T daggc  (all f32)
// The TPU kernel holds a whole tile and carries the parameter sums across
// its sequential grid. Here dx for a strip needs daggc for all rows of its
// tile, and dagg needs all D2 columns of dmid, so the backward is a chain
// of launches on one stream, each deterministic, all on the row-block
// products (fused_bn_common.cuh; FP32 FMA in f32, mma.sync m16n8k16 tensor
// cores with f32 sums in bf16):
//   * W1^T and W2^T, transposed once so that their rows stream;
//   * the dmid launch, one block per (16-row strip, 128-column slice of
//     dmid): gt and gtc for the strip's rows, then its slice of dmidc and
//     of the strip's db1 partial (gine_bwd_dmid_kernel); the slice-0 block
//     writes gtc, the db2 partial and the strip's live flag (0 when every
//     gt value of the strip is exactly zero, padding rows included);
//   * the dagg launch, one block per (strip, 128-column slice of dagg):
//     daggc = rnd(dmidc @ W1^T) (gine_bwd_dagg_kernel);
//   * the adjacency pass, K5f's (adj_pass_kernel, 16-row strips): dx =
//     A_strip @ daggc over the strip's live 32-column chunks only, then the
//     prologue adjoint, dh and the strip's [da | db] partials (BnAdjoint);
//   * the weight pass (wgrad_kernel): dW1, dW2 and detab as three
//     transposed-left problems of one launch over row chunks, strips whose
//     flag is 0 skipped;
// and every partial is added in a fixed order (sum_partials). Dead strips
// (flag 0) write zeros in the dmid and dagg launches with no product. No
// atomics: two runs are bit-identical. In f32 each output is one thread's
// sum in the first design's order (products over k ascending; db1 and the
// [da | db] partials each group of four rows, then the groups; db2 one
// thread per column, rows ascending; the weight pass's chunks of at most
// 1,024 rows, rows ascending), and a skipped term is an exact zero, so the
// f32 results are bit-identical to the first design's (strip passes of 4
// x 4 FMA tiles on CUDA cores, a dense adjacency strip, a weight pass over
// the same row chunks).
//
// Bound on the H100 at the pretraining shape (T = 22, D = 300, 4,696 real
// rows of 5,632, f32): four dense products over the real rows, 4 x 2 x
// 4,696 x 300 x 600 = 6.8 GFLOP, plus A @ daggc and cnt^T daggc by their
// nonzeros, against about 40 MB moved: 0.10 ms at 67 TFLOP/s. In bf16 the
// bytes set the bound (about 7 us). What still holds it back (PERF.md):
// the f32 weight pass, the largest launch, issues FMA on X and Y slabs that
// every output tile re-reads; the f32 products of row blocks are bound by
// shared-memory loads and cover the padded rows of live strips; dmidc, gtc
// and daggc round-trip device memory (L2) between the launches; no wgmma,
// no TMA. The f32 sums keep the first design's order (ROADMAP queue 2),
// which rules out split-K and TF32.

// K4b replaces molclr_tpu/ops/fused_layer.py:_bwd_kernel, the backward
// of the unchained layer fused_gine_layer (K4f, in fused_gine_bn.cu):
//   dmid = (g @ W2^T) * [mid > 0], dagg = rnd(rnd(dmid) @ W1^T),
//   dh = rnd(A @ daggc), dW1 = agg^T dmidc, db1 = sum dmid,
//   dW2 = mid^T g, db2 = sum g, detab = cnt^T daggc.
// K4b is K1b's launches instantiated with BN = false (gt = g with no dsums
// term, no prologue adjoint: its adjacency pass writes dh = rnd(dx), K5f's
// function); nothing of BatchNorm is computed. At the fine-tuning shape (T
// = 4) the dmid launch runs 64 x 5 = 320 blocks of 16 rows, the dagg and
// adjacency launches 64 x 3, and the f32 weight pass (one 1,024-row chunk)
// 32 x 64 output tiles, 200 blocks, so that each launch reaches the 132
// SMs (the 40 live strips' 120 dagg and adjacency blocks excepted). Bound
// on the H100 at the fine-tuning shape (619 real rows of 1,024, f32):
// twice K4f's operations, 13 us.

#include "fused_bn_common.cuh"

namespace fbl {

// K1b's and K4b's row passes, blocks of RNT threads on one 16-row strip
// (BN: K1b).
//   gine_bwd_dmid_kernel, one block per (strip, 128-column slice of dmid):
//     gt for its rows over all D columns (K1b: g + m (ds0 + 2 out ds1), each
//     operation rounded as the plain version rounds it; K4b: g) as the
//     left operand gtc = rnd(gt) in shared memory; its slice of dmid =
//     (gtc @ W2^T) [mid > 0] through the weight ring, dmidc = rnd(dmid), and
//     the strip's db1 partial for the slice, its rows summed as the first
//     design summed them (each group of four rows, then the groups in
//     order). The slice-0 block writes gtc (K1b), the strip's db2 partial
//     (one thread per column, rows ascending) and its live flag: 0 when
//     every gt value of the strip is exactly zero, whatever its rows are (a
//     padding row's g counts). A dead strip's blocks write dmidc = 0 and
//     zero db1 partials and stop.
//   gine_bwd_dagg_kernel, one block per (strip, 128-column slice of dagg):
//     dmidc's rows as the operand, daggc = rnd(dmidc @ W1^T); a dead
//     strip's blocks write zeros.
// w1t [D2, D] and w2t [D, D2] are W1^T and W2^T, so that their rows
// stream. The dagg launch streams dmidc's rows in K-chunks (STREAM) where
// [16, D2] of them do not fit in shared memory (f32 above about D2 =
// 3,000). Where the dmid launch cannot hold gtc [16, D] (f32 above about D
// = 3,000), gine_bwd_gt_kernel first writes gt's parts that the slice-0
// block writes (gtc for K1b, the db2 partial, the live flag; K4b's gtc is g
// itself) and the dmid launch (STREAM) streams gtc's rows in K-chunks. K4b's
// members (MEM): grid z, as K4f's (g, mid, agg, W^T, dmidc, daggc, dh, the
// strip flags and every partial per member, the adjacency and counts
// shared).
template <typename T, bool BN, bool MEM>
__global__ void __launch_bounds__(RNT)
gine_bwd_gt_kernel(const T* __restrict__ g, const float* __restrict__ ds,
                   const T* __restrict__ adj, const T* __restrict__ out,
                   T* __restrict__ gtc, int* __restrict__ strip_live,
                   float* __restrict__ partial, int S, int D, int D2) {
  __shared__ float msk[R];
  __shared__ int live;
  if constexpr (MEM) {  // member blockIdx.z (K4b)
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    g += z * N * D;
    strip_live += z * gridDim.x;
    partial += z * gridDim.x * (D2 + D);
  }
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * R;
  float* prow = partial + (size_t)blockIdx.x * (D2 + D);
  if (tid == 0) live = 0;
  if (BN && tid < R) {
    const size_t r = row0 + tid;
    msk[tid] = ld(adj, r * S + r % S) > 0.f ? 1.f : 0.f;
  }
  __syncthreads();
  for (int c = tid; c < D; c += RNT) {
    float s = 0.f;
    bool nz = false;
    for (int r = 0; r < R; ++r) {
      const size_t e = (row0 + r) * D + c;
      float gt;
      if constexpr (BN) {
        const float t =
            __fadd_rn(ds[c], __fmul_rn(2.f * ld(out, e), ds[D + c]));
        gt = __fadd_rn(ld(g, e), msk[r] * t);
        st(gtc, e, gt);
      } else {
        gt = ld(g, e);
      }
      s += gt;
      nz |= gt != 0.f;
    }
    prow[D2 + c] = s;
    if (nz) live = 1;
  }
  __syncthreads();
  if (tid == 0) strip_live[blockIdx.x] = live;
}

template <typename T, bool BN, bool MEM, bool STREAM = false>
__global__ void __launch_bounds__(RNT, 2)
gine_bwd_dmid_kernel(const T* __restrict__ g, const float* __restrict__ ds,
                     const T* __restrict__ adj, const T* __restrict__ mid,
                     const T* __restrict__ out, const T* __restrict__ w2t,
                     T* __restrict__ gtc, T* __restrict__ dmidc,
                     int* __restrict__ strip_live,
                     float* __restrict__ partial, int S, int D, int D2,
                     int ring, int ka) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int live;
  if constexpr (MEM) {  // member blockIdx.z (K4b)
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    g += z * N * D;
    mid += z * N * D2;
    w2t += z * D * D2;
    dmidc += z * N * D2;
    strip_live += z * gridDim.x;
    partial += z * gridDim.x * (D2 + D);
  }
  const RbSmem L = row_operand_smem<T>(STREAM ? ka : D, ring);
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* ga = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of dmid
  const bool first = blockIdx.y == 0;
  // the strip's [db1 | db2] partials
  float* prow = partial + (size_t)blockIdx.x * (D2 + D);
  const int lda = a_lda(D);
  if constexpr (STREAM) {
    if (tid == 0) live = strip_live[blockIdx.x];
  } else {
    if (tid == 0) live = 0;
    if (BN && tid < R) {
      const size_t r = row0 + tid;
      msk[tid] = ld(adj, r * S + r % S) > 0.f ? 1.f : 0.f;
    }
    a_zero_cols<R>(ga, lda, D, D);
    __syncthreads();
    for (int c = tid; c < D; c += RNT) {
      float v[R];
      float s = 0.f;
      bool nz = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t e = (row0 + r) * D + c;
        float gt;
        if constexpr (BN) {
          const float t =
              __fadd_rn(ds[c], __fmul_rn(2.f * ld(out, e), ds[D + c]));
          gt = __fadd_rn(ld(g, e), msk[r] * t);
          v[r] = rnd<T>(gt);
          if (first) st(gtc, e, v[r]);
        } else {
          gt = v[r] = ld(g, e);
        }
        s += gt;
        nz |= gt != 0.f;
      }
      if (first) prow[D2 + c] = s;
      if (nz) live = 1;
      // column c of the operand: k-major in f32 (R consecutive floats,
      // stored as float4), row-major in bf16
      if constexpr (sizeof(T) == 4) {
        float4* a4 = reinterpret_cast<float4*>(ga) + (size_t)c * (R / 4);
#pragma unroll
        for (int q = 0; q < R / 4; ++q)
          a4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                              v[4 * q + 3]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) a_put<R>(ga, lda, r, c, v[r]);
      }
    }
  }
  __syncthreads();
  if (!STREAM && first && tid == 0) strip_live[blockIdx.x] = live;
  // thread tid < RCW: column cb + tid of the strip's db1 partial
  const int pc = cb + tid;
  const bool pown = tid < RCW && pc < D2;
  if (!live) {
    for (int e = tid; e < R * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D2) st(dmidc, (row0 + r) * D2 + c, 0.f);
    }
    if (pown) prow[pc] = 0.f;
    return;
  }
  if constexpr (STREAM)
    rb_pass_streamed<T, R, true>(ring, ka, ga, BN ? gtc : g, row0, R, D, cb,
                                 D2, scratch, w2t, D2);
  else
    rb_pass_wr<T, R>(ring, ga, lda, D, cb, D2, scratch, w2t, D2);
  for (int e = tid; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D2) {
      const size_t i = (row0 + r) * D2 + c;
      const float dm = ld(mid, i) > 0.f ? scratch[r * CS + j] : 0.f;
      scratch[r * CS + j] = dm;
      st(dmidc, i, dm);
    }
  }
  __syncthreads();
  if (pown) {
    float t = 0.f;
    for (int w = 0; w < 4; ++w) {
      float s = 0.f;
      for (int i = 0; i < 4; ++i) s += scratch[(4 * w + i) * CS + tid];
      t += s;
    }
    prow[pc] = t;
  }
}

template <typename T, bool MEM, bool STREAM>
__global__ void __launch_bounds__(RNT, 2)
gine_bwd_dagg_kernel(const T* __restrict__ dmidc, const T* __restrict__ w1t,
                     const int* __restrict__ strip_live,
                     T* __restrict__ daggc, int D, int D2, int ring,
                     int ka) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  if constexpr (MEM) {  // member blockIdx.z
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    dmidc += z * N * D2;
    w1t += z * D2 * D;
    strip_live += z * gridDim.x;
    daggc += z * N * D;
  }
  const RbSmem L = row_operand_smem<T>(STREAM ? ka : D2, ring);
  T* ma = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of dagg
  if (!strip_live[blockIdx.x]) {
    for (int e = threadIdx.x; e < R * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D) st(daggc, (row0 + r) * D + c, 0.f);
    }
    return;
  }
  rb_pass_streamed<T, R, STREAM>(ring, ka, ma, dmidc, row0, R, D2, cb, D,
                                 scratch, w1t, D);
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) st(daggc, (row0 + r) * D + c, scratch[r * CS + j]);
  }
}

// K1b (BN) or K4b: W1^T and W2^T, the dmid, dagg and adjacency passes, the
// weight pass and the fixed-order sums. Scratch: w1t [D2, D], w2t [D, D2],
// gtc (K1b), daggc [N, D], dmidc [N, D2] (T), strip_live [N / 16] and the
// partials part_rows [N / 16, D2 + D], part_adj [N / 16, 2 D] (K1b),
// part_w [chunks, width]. Outputs: dh [N, D] (T); sums_rows [D2 + D] =
// [db1 | db2]; sums_adj [2 D] = [da | db] (K1b); wgrad [width = D*D2 +
// D2*D + CNT_PAD*D] = [dW1 | dW2 | detab] (f32). The weight pass's chunks,
// rows per chunk and tile rows are the caller's (ops/fused_layer.py
// gine_bwd_weight_shape; launch_wgrad checks them). K4b passes null for ds,
// h, a, b, out, gtc, part_adj and sums_adj, and its dW2 multiplies g
// itself. M members (K4b; K1b runs one): every buffer but adj and cnt is a
// stack of M, each member's as large as one layer's.
template <typename T, bool BN>
static int gine_bwd(const void* g, const float* ds, const void* h,
                    const float* a, const float* b, const void* adj,
                    const void* cnt, const void* agg, const void* mid,
                    const void* out, const void* w1, const void* w2,
                    void* w1t, void* w2t, void* gtc, void* dmidc, void* daggc,
                    int* strip_live, float* part_rows, float* part_adj,
                    float* part_w, void* dh, float* sums_rows,
                    float* sums_adj, float* wgrad, int T_, int S, int D,
                    int D2, int relu_in, int chunks, int rows_per_chunk,
                    int tile_rows, int M, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0 || chunks <= 0 ||
      M <= 0 || (BN && M != 1))
    return (int)cudaErrorInvalidValue;
  const int N = T_ * S, nstrip = N / R;
  cudaStream_t st = (cudaStream_t)stream;
  // each row launch's operand [16, K] held whole, or K-chunks of it
  auto row_shape = [](int K) {
    return rb_stream(K, [&](int ka) {
      return rb_shape_two([&](int, int rg) {
        return row_operand_smem<T>(ka, rg).total;
      });
    });
  };
  const RbShape sm = row_shape(D), sa = row_shape(D2);
  if (!sm.rb || !sa.rb) return (int)cudaErrorInvalidValue;

  int err = launch_transpose<T>(w1, w1t, D, D2, st, M);
  if (err) return err;
  if ((err = launch_transpose<T>(w2, w2t, D2, D, st, M))) return err;

  // (K1b launches one member; K4b's one-member instantiations compile
  // without the member offsets)
  const bool mem = !BN && M > 1;
  auto dmidk = mem ? (sm.ka ? gine_bwd_dmid_kernel<T, BN, !BN, true>
                            : gine_bwd_dmid_kernel<T, BN, !BN>)
                   : (sm.ka ? gine_bwd_dmid_kernel<T, BN, false, true>
                            : gine_bwd_dmid_kernel<T, BN, false>);
  auto daggk = mem ? (sa.ka ? gine_bwd_dagg_kernel<T, !BN, true>
                            : gine_bwd_dagg_kernel<T, !BN, false>)
                   : (sa.ka ? gine_bwd_dagg_kernel<T, false, true>
                            : gine_bwd_dagg_kernel<T, false, false>);
  cudaError_t e;
  if (sm.ka) {  // gtc streams: its parts of the slice-0 block first
    auto gtk = mem ? gine_bwd_gt_kernel<T, BN, !BN>
                   : gine_bwd_gt_kernel<T, BN, false>;
    gtk<<<dim3(nstrip, 1, M), RNT, 0, st>>>(
        (const T*)g, ds, (const T*)adj, (const T*)out, (T*)gtc, strip_live,
        part_rows, S, D, D2);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if ((e = set_smem(dmidk, sm.bytes)) != cudaSuccess) return (int)e;
  dmidk<<<dim3(nstrip, (D2 + RCW - 1) / RCW, M), RNT, sm.bytes, st>>>(
      (const T*)g, ds, (const T*)adj, (const T*)mid, (const T*)out,
      (const T*)w2t, (T*)gtc, (T*)dmidc, strip_live, part_rows, S, D, D2,
      sm.ring, sm.ka);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = set_smem(daggk, sa.bytes)) != cudaSuccess) return (int)e;
  daggk<<<dim3(nstrip, (D + RCW - 1) / RCW, M), RNT, sa.bytes, st>>>(
      (const T*)dmidc, (const T*)w1t, strip_live, (T*)daggc, D, D2, sa.ring,
      sa.ka);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t nd = (size_t)N * D, nd2 = (size_t)N * D2;
  if constexpr (BN)
    err = launch_adj_pass<T>(
        daggc, adj,
        BnAdjoint<T>{(const T*)h, a, b, (T*)dh, nullptr, part_adj, D,
                     relu_in},
        N, S, D, st);
  else if (M > 1)
    err = launch_adj_pass<T>(daggc, adj, AdjStoreMembers<T>{(T*)dh, D, nd},
                             N, S, D, st, nullptr, nullptr, M);
  else
    err = launch_adj_pass<T>(daggc, adj, AdjStore<T>{(T*)dh, D}, N, S, D,
                             st);
  if (err) return err;

  const int width = 2 * D * D2 + CNT_PAD * D;
  const WProb p[3] = {{agg, dmidc, D, D2, 0, nd, nd2},
                      {mid, BN ? (const void*)gtc : g, D2, D, D * D2, nd2,
                       nd},
                      {cnt, daggc, CNT_PAD, D, 2 * D * D2, 0, nd}};
  err = launch_wgrad<T>(p, 3, strip_live, N, rows_per_chunk, chunks,
                        tile_rows, part_w, width, st, M);
  if (err) return err;

  if ((err = launch_sum_partials(part_rows, sums_rows, nstrip, D2 + D, st,
                                 M)))
    return err;
  if constexpr (BN) {
    err = launch_sum_partials(part_adj, sums_adj, nstrip, 2 * D, st);
    if (err) return err;
  }
  return launch_sum_partials(part_w, wgrad, chunks, width, st, M);
}

}  // namespace fbl

extern "C" {

#define GINE_BN_BWD(suffix, T)                                              \
  int gine_bn_bwd_##suffix(                                                 \
      const void* g, const float* ds, const void* h, const float* a,        \
      const float* b, const void* adj, const void* cnt, const void* agg,    \
      const void* mid, const void* out, const void* w1, const void* w2,     \
      void* w1t, void* w2t, void* gtc, void* dmidc, void* daggc,            \
      int* strip_live, float* part_rows, float* part_adj, float* part_w,    \
      void* dh, float* sums_rows, float* sums_adj, float* wgrad, int T_,    \
      int S, int D, int D2, int relu_in, int chunks, int rows_per_chunk,    \
      int tile_rows, void* stream) {                                        \
    return fbl::gine_bwd<T, true>(g, ds, h, a, b, adj, cnt, agg, mid, out,  \
                                  w1, w2, w1t, w2t, gtc, dmidc, daggc,      \
                                  strip_live, part_rows, part_adj, part_w,  \
                                  dh, sums_rows, sums_adj, wgrad, T_, S, D, \
                                  D2, relu_in, chunks, rows_per_chunk,      \
                                  tile_rows, 1, stream);                    \
  }

// K4b: dh, [db1 | db2] and [dW1 | dW2 | detab] of the unchained layer, for
// M members stacked as gine_fwd_* takes them (scratch and results too).
#define GINE_BWD(suffix, T)                                                 \
  int gine_bwd_##suffix(const void* g, const void* adj, const void* cnt,    \
                        const void* agg, const void* mid, const void* w1,   \
                        const void* w2, void* w1t, void* w2t, void* dmidc,  \
                        void* daggc, int* strip_live, float* part_rows,     \
                        float* part_w, void* dh, float* sums_rows,          \
                        float* wgrad, int T_, int S, int D, int D2,         \
                        int chunks, int rows_per_chunk, int tile_rows,      \
                        int M, void* stream) {                              \
    return fbl::gine_bwd<T, false>(                                         \
        g, nullptr, nullptr, nullptr, nullptr, adj, cnt, agg, mid, nullptr, \
        w1, w2, w1t, w2t, nullptr, dmidc, daggc, strip_live, part_rows,     \
        nullptr, part_w, dh, sums_rows, nullptr, wgrad, T_, S, D, D2, 0,    \
        chunks, rows_per_chunk, tile_rows, M, stream);                      \
  }

GINE_BN_BWD(f32, float)
GINE_BN_BWD(bf16, __nv_bfloat16)
GINE_BWD(f32, float)
GINE_BWD(bf16, __nv_bfloat16)

}  // extern "C"
