// K1f and K1b: BN-chained fused GINE layer, forward and backward, for
// sm_90a.
//
// K1f replaces molclr_tpu/ops/fused_layer.py:_bn_fwd_kernel (the Pallas TPU
// kernel behind fused_gine_bn_layer). Per node row:
//   y   = rnd(relu?(h * a + b))                 prologue: previous BN affine
//   agg = rnd(A @ y + cnt @ etab)               neighbor + edge-emb sums
//   mid = rnd(relu(agg @ W1 + b1))
//   out = rnd(mid @ W2 + b2)
//   sums += [sum m out, sum m out^2]            m = diag(A) > 0
// rnd() is the cast to the activation type T (float or bf16); every sum is
// f32. agg and mid are written to device memory only when the caller asks
// for them (the residuals of a training step); serving passes null.
//
// Design (the row-block products of fused_bn_common.cuh): k1f_kernel runs
// one block of 256 threads per 32 rows (two 16-row strips, so that each W1
// and W2 chunk a block stages serves 32 rows; 176 blocks at the
// pretraining shape T = 22, 144 at the embed shape T = 18). The block
//   * reads its A rows once, finds the live 32-column chunks (those with a
//     nonzero) and builds its stage-1 operand [A live chunks | cnt rows]:
//     the prologue y = rnd(relu?(h a + b)) is computed only for the nodes
//     of live chunks (about 3 of 8 per block in a pretraining batch);
//   * keeps agg and mid in shared memory as the next stage's operand and
//     streams W1 and W2 through a ring of cp.async stages (f32: three
//     64-row chunks; bf16: four 32-row chunks), so that the next chunks
//     are in flight while one is multiplied;
//   * multiplies in f32 with FP32 FMA (4 x 4 outputs per thread) or in
//     bf16 with mma.sync m16n8k16 tensor-core products, f32 sums;
//   * when its A and cnt rows are all zero (a dead block, padding only),
//     computes nothing: agg = 0, mid = rnd(relu(b1)), and every row gets
//     the one constant out row that k1f_dead_row_kernel computed before it
//     (zero moment partials).
// Each output is summed over k in ascending order by one thread, as the
// first design's strips summed it, and the moment partials are taken per
// 16-row strip in the first design's order and added in strip order by
// sum_partials: in f32 the results are bit-identical to the first
// design's (a skipped term is an exact 0), no atomics, runs bit-identical.
// Shared memory at S = 256, D = 300, D2 = 600: 217 KB in f32 (one block
// per SM), 100 KB in bf16. Wider layers and tiles first take a shallower
// f32 weight ring (two 32-row chunks), then 16-row blocks, whatever fits
// (k1f_launch_shape); the order of every sum stays the same.
//
// Bound on the H100 at the embed shape (T = 18 tiles of 256, D = 300,
// f32): as a dense computation 4.07 GFLOP (A@y 0.71, cnt@etab 0.04, two
// MLP products 3.32); the work this batch needs is less, 1.7 GFLOP (the
// adjacency and counts by their nonzeros, the MLP over the 2,358 real
// rows of 4,608), against 17 MB moved (h, out 5.5 MB each, A 4.7 MB,
// W1/W2 0.7 MB each). So it is bound by operations: 25 us at the 67
// TFLOP/s f32 rate without tensor cores, against 5 us for the bytes. In
// bf16 the operations take 1.7 us at 989 TFLOP/s and the 8.8 MB 2.6 us.
//
// What still holds it back: every block streams all of W1 and W2 from L2
// (1.44 MB in f32 per 32 rows; at T = 22 the 150 live blocks take two
// rounds of the 132 SMs, and the first runs slower than the second as all
// SMs draw on L2 at once); the MLP runs over padded rows of live blocks;
// no TMA multicast of the weight chunks across a cluster, no wgmma.
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

// K4f and K4b replace molclr_tpu/ops/fused_layer.py:_fwd_kernel and
// _bwd_kernel, the unchained layer fused_gine_layer that the fine-tuning
// trunk runs (drop_ratio > 0: BatchNorm, relu and dropout run outside):
//   agg = rnd(A @ h + cnt @ etab), mid = rnd(relu(agg @ W1 + b1)),
//   out = rnd(mid @ W2 + b2), with agg and mid written as residuals;
//   dmid = (g @ W2^T) * [mid > 0], dagg = rnd(rnd(dmid) @ W1^T),
//   dh = rnd(A @ daggc), dW1 = agg^T dmidc, db1 = sum dmid,
//   dW2 = mid^T g, db2 = sum g, detab = cnt^T daggc.
// K4b is K1b's launches instantiated with BN = false (gt = g with no dsums
// term, no prologue adjoint: its adjacency pass writes dh = rnd(dx), K5f's
// function); nothing of BatchNorm is computed. At the fine-tuning shape (T
// = 4) the dmid launch runs 64 x 5 = 320 blocks of 16 rows, the dagg and
// adjacency launches 64 x 3, and the f32 weight pass (one 1,024-row chunk)
// 32 x 64 output tiles, 200 blocks, so that each launch reaches the 132
// SMs (the 40 live strips' 120 dagg and adjacency blocks excepted).
//
// K4f is two row-block launches (k4f_mid_kernel, k4f_out_kernel) of
// 16-row blocks with the 64 KB f32 weight ring, so that two blocks share
// an SM (the 32 KB ring where a wider layer does not fit). At the
// fine-tuning shape (T = 4 tiles of 256, D = 300, D2 = 600):
//   * the mid launch, 64 row blocks x 5 slices of 128 columns = 320
//     blocks (37.5 % of the row blocks dead on the fine-tuning batch:
//     they write agg = 0 and mid = rnd(relu(b1)) and stop). A live block
//     skips its all-zero 32-column adjacency chunks (85.7 % of the (strip,
//     chunk) products), computes agg over [A live chunks | cnt] for all D
//     columns (the features of the live chunks' nodes gathered through
//     the weight ring), and its slice of mid = rnd(relu(agg W1 + b1));
//   * the out launch, 64 x 3 = 192 blocks of out = rnd(mid W2 + b2),
//     dead rows included (their product gives the first design's bits).
// The first design ran 64 strip blocks on CUDA cores in bf16 too. In f32
// every output is still one thread's sum over k in ascending order, so
// the results are bit-identical to the first design's; bf16 runs mma.sync
// tensor cores with f32 sums.
//
// Bound on the H100 at the fine-tuning shape (619 real rows of 1,024,
// f32): K4f 0.45 GFLOP (the two MLP products over the real rows; the
// adjacency and counts by their nonzeros add 2 MFLOP) against 8.7 MB
// moved (h, out, agg, mid, A, W1, W2): 6.7 us by operations; K4b twice
// the operations, 13 us. In bf16 K4f is bound by its 4.4 MB, 1.3 us. What
// holds K4f back (runs/port_unchained_trace.py, PERF.md): the f32 products
// of a 16-row block run at about two shared-memory wavefronts per eight
// FMA a thread, near that bound when two blocks share an SM, and over
// padded rows of live blocks and dead rows of the out launch; each live
// mid block also spends about 7 us scanning its adjacency rows and
// building its operand before the first product.

#include "fused_bn_common.cuh"

namespace fbl {

// K1f: one block of RNT threads per RB rows, RB = K1F_RB = 32 (two 16-row
// strips; when the tile size is not a multiple of 32 the two may lie in
// different tiles) or, where a 32-row block's operands do not fit in shared
// memory, 16 (k1f_launch_shape). Shared memory, in order: the live-chunk
// list, the node mask, the region X (stage 1's operand [A live chunks | cnt
// rows], then mid), the agg operand and the pass scratch with the f32
// weight ring `ring` (k1f_smem).
constexpr int K1F_RB = 32;

template <typename T>
__host__ __device__ inline RbSmem k1f_smem(int S, int D, int D2, int rb,
                                           int ring) {
  const int nch = (S + ACW - 1) / ACW, maxc = (S % rb ? 2 : 1) * nch;
  const size_t x = a_bytes<T>(rb, maxc * ACW + CNT_PAD);
  const size_t m = a_bytes<T>(rb, D2);
  return rb_smem(S, maxc, x > m ? x : m, a_bytes<T>(rb, D),
                 pass_bytes<T>(rb, ring));
}

// K1f's block rows and f32 weight ring at this shape (rb_shape from 32
// rows and ring 0), so that wide layers keep the 32-row blocks that share
// each weight chunk and give up pipeline depth first. At S = 256 in f32
// ring 0 takes D = 300 / D2 = 600 (217 KB), ring 1 up to D = 512 / D2 =
// 1,024, 16-row blocks up to D = 1,024 / D2 = 2,048.
template <typename T>
static RbShape k1f_launch_shape(int S, int D, int D2) {
  return rb_shape(K1F_RB, 0, [&](int rb, int ring) {
    return k1f_smem<T>(S, D, D2, rb, ring).total;
  });
}

// The output row of a row whose agg is 0: mid = rnd(relu(b1)), row[c] =
// rnd(mid @ W2 + b2)[c] (f32 holding a value of type T), each column one
// thread's sum over k in ascending order, as the row-block products sum.
template <typename T>
__global__ void __launch_bounds__(RNT)
k1f_dead_row_kernel(const float* __restrict__ b1, const T* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ row,
                    int D, int D2) {
  const int c = blockIdx.x * RNT + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  // (unrolled deep so that many loads of W2 are in flight at once: the
  // sum itself is one dependent chain)
#pragma unroll 32
  for (int k = 0; k < D2; ++k)
    s = fmaf(rnd<T>(fmaxf(b1[k], 0.f)), ld(w2, (size_t)k * D + c), s);
  row[c] = rnd<T>(s + b2[c]);
}

// bf16 blocks (100 KB of shared memory at the reference width) are held to
// 128 registers so that two run on an SM (the pretraining shape's 150 live
// blocks then take one round of the 132 SMs, for some register spills);
// f32 blocks (217 KB) run one to an SM.
template <typename T, int RB>
__global__ void __launch_bounds__(RNT, sizeof(T) == 2 ? 2 : 1)
k1f_kernel(const T* __restrict__ h, const float* __restrict__ a,
           const float* __restrict__ b, const T* __restrict__ adj,
           const T* __restrict__ cnt, const T* __restrict__ etab,
           const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2,
           T* __restrict__ out, T* __restrict__ agg_out,
           T* __restrict__ mid_out, float* __restrict__ partial,
           const float* __restrict__ dead_row, int N, int S, int D, int D2,
           int relu_in, int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int cnt_live;
  const RbSmem L = k1f_smem<T>(S, D, D2, RB, ring);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  int* knode = width + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* xa = reinterpret_cast<T*>(smem + L.op0);
  T* ga = reinterpret_cast<T*>(smem + L.op1);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * RB;
  const int nrows = min(RB, N - (int)row0);
  // the moment partials of the block's RB / 16 strips, from row
  // blockIdx.x * RB / 16 of partial
  float* prow = partial + (size_t)blockIdx.x * (RB / R) * (2 * D);

  const bool clive = cnt_rows_live(cnt, row0, nrows, &cnt_live);
  const int nlive = adj_live_chunks(adj, row0, nrows, S, flags, node, width,
                                    msk);

  if (nlive == 0 && !clive) {
    // A dead block: agg = 0, so every row is mid = rnd(relu(b1)) and the
    // constant row out = rnd(mid @ W2 + b2) that k1f_dead_row_kernel left
    // in dead_row; zero moment partials (no row is a node).
    for (int e = tid; e < nrows * D; e += RNT) {
      st(out, row0 * D + e, dead_row[e % D]);
      if (agg_out) st(agg_out, row0 * D + e, 0.f);
    }
    if (mid_out)
      for (int e = tid; e < nrows * D2; e += RNT)
        st(mid_out, row0 * D2 + e, rnd<T>(fmaxf(b1[e % D2], 0.f)));
    for (int e = tid; e < (nrows / R) * 2 * D; e += RNT) prow[e] = 0.f;
    return;
  }

  // stage 1: agg = rnd([A live chunks | cnt] @ [y ; etab]), y = rnd(relu?(h
  // a + b)) for the nodes of the live chunks only
  const int KL = nlive * ACW, K1 = KL + CNT_PAD;
  const int lda1 = a_lda(K1), lda2 = a_lda(D), lda3 = a_lda(D2);
  a_zero_cols<RB>(ga, lda2, D, D);
  adj_operand<RB>(adj, cnt, row0, nrows, S, nlive, node, width, knode, xa,
                  lda1);
  auto load1 = [&](int k, int c) -> T {
    const T* p = k < KL ? h + (size_t)knode[k] * D : etab + (size_t)(k - KL) * D;
    return p[c];
  };
  auto xf1 = [&](int c) {
    const float ac = a[c], bc = b[c];
    return [=](int k, float v) -> float {
      return k < KL ? rnd<T>(prologue(v, ac, bc, relu_in)) : v;
    };
  };
  for (int c0 = 0; c0 < D; c0 += RCW) {
    rb_pass<T, RB>(xa, lda1, K1, c0, D, scratch, load1, xf1);
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) {
        const float v = rnd<T>(scratch[r * CS + j]);
        scratch[r * CS + j] = v;
        if (agg_out && r < nrows) st(agg_out, (row0 + r) * D + c, v);
      }
    }
    __syncthreads();
    cs_to_a<RB>(ga, lda2, c0, D, scratch);
  }

  // stage 2: mid = rnd(relu(agg @ W1 + b1)) into region X (stage 1's
  // operand is dead)
  a_zero_cols<RB>(xa, lda3, D2, D2);
  for (int c0 = 0; c0 < D2; c0 += RCW) {
    rb_pass_wr<T, RB>(ring, ga, lda2, D, c0, D2, scratch, w1, D2);
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D2) {
        const float v = rnd<T>(fmaxf(scratch[r * CS + j] + b1[c], 0.f));
        scratch[r * CS + j] = v;
        if (mid_out && r < nrows) st(mid_out, (row0 + r) * D2 + c, v);
      }
    }
    __syncthreads();
    cs_to_a<RB>(xa, lda3, c0, D2, scratch);
  }

  // stage 3: out = rnd(mid @ W2 + b2) and the masked moments of the cast
  // out, summed over the block's rows in row order
  for (int c0 = 0; c0 < D; c0 += RCW) {
    rb_pass_wr<T, RB>(ring, xa, lda3, D2, c0, D, scratch, w2, D);
    for (int e = tid; e < RB * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) {
        const float v = rnd<T>(scratch[r * CS + j] + b2[c]);
        scratch[r * CS + j] = v;
        if (r < nrows) st(out, (row0 + r) * D + c, v);
      }
    }
    __syncthreads();
    // thread (strip st, column j): the strip's sums over its four groups
    // of four rows, each group's sum then the groups in order
    const int st = tid / RCW, j = tid % RCW, c = c0 + j;
    if (16 * st < nrows && c < D) {
      float t0 = 0.f, t1 = 0.f;
      for (int w = 0; w < 4; ++w) {
        float s0 = 0.f, s1 = 0.f;
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * st + 4 * w + i;
          const float v = scratch[r * CS + j], ob = v * msk[r];
          s0 += ob;
          s1 += ob * v;
        }
        t0 += s0;
        t1 += s1;
      }
      prow[(size_t)st * 2 * D + c] = t0;
      prow[(size_t)st * 2 * D + D + c] = t1;
    }
  }
}

// K4f: two launches of 16-row blocks (k4f_launch_shape: the 64 KB f32
// ring, the 32 KB one where shared memory does not fit).
//   k4f_mid_kernel, one block per (row block, 128-column slice of mid):
//     agg = rnd([A live chunks | cnt] @ [h ; etab]) for all D columns of
//     its rows (recomputed by every slice: a cheap sparse product), kept in
//     shared memory, then its slice of mid = rnd(relu(agg @ W1 + b1)). The
//     slice-0 block writes agg when asked. A dead block (its A and cnt rows
//     all zero) writes agg = 0 and mid = rnd(relu(0 + b1)) with no product.
//   k4f_out_kernel, one block per (row block, 128-column slice of out):
//     its mid rows as the operand, out = rnd(mid @ W2 + b2). Dead rows run
//     the product on their rnd(relu(b1)) rows, as the first design did.
template <typename T>
__host__ __device__ inline RbSmem k4f_mid_smem(int S, int D, int ring) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(R, nch * ACW + CNT_PAD),
                 a_bytes<T>(R, D), pass_bytes<T>(R, ring));
}

template <typename T>
__host__ __device__ inline RbSmem k4f_out_smem(int D2, int ring) {
  return rb_smem(0, 0, a_bytes<T>(R, D2), 0, pass_bytes<T>(R, ring));
}

// (two blocks an SM by registers; shared memory decides the rest)
template <typename T>
__global__ void __launch_bounds__(RNT, 2)
k4f_mid_kernel(const T* __restrict__ h, const T* __restrict__ adj,
               const T* __restrict__ cnt, const T* __restrict__ etab,
               const T* __restrict__ w1, const float* __restrict__ b1,
               T* __restrict__ agg_out, T* __restrict__ mid, int S, int D,
               int D2, int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int cnt_live;
  const RbSmem L = k4f_mid_smem<T>(S, D, ring);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  int* knode = width + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* xa = reinterpret_cast<T*>(smem + L.op0);
  T* ga = reinterpret_cast<T*>(smem + L.op1);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of mid
  T* const agg_w = blockIdx.y == 0 ? agg_out : nullptr;

  const bool clive = cnt_rows_live(cnt, row0, R, &cnt_live);
  const int nlive = adj_live_chunks(adj, row0, R, S, flags, node, width,
                                    msk);
  if (nlive == 0 && !clive) {
    if (agg_w)
      for (int e = tid; e < R * D; e += RNT) st(agg_w, row0 * D + e, 0.f);
    for (int e = tid; e < R * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D2)
        st(mid, (row0 + r) * D2 + c, rnd<T>(fmaxf(0.f + b1[c], 0.f)));
    }
    return;
  }

  const int KL = nlive * ACW, K1 = KL + CNT_PAD;
  const int lda1 = a_lda(K1), lda2 = a_lda(D);
  a_zero_cols<R>(ga, lda2, D, D);
  adj_operand<R>(adj, cnt, row0, R, S, nlive, node, width, knode, xa, lda1);
  // [h ; etab] streams through the ring: row k is node knode[k]'s features
  // for the live chunks' columns, then etab's rows
  auto brow = [&](int k) {
    return k < KL ? h + (size_t)knode[k] * D : etab + (size_t)(k - KL) * D;
  };
  const bool wide = rows_wide(D, h, etab);
  for (int c0 = 0; c0 < D; c0 += RCW) {
    rb_pass_rr<T, R>(ring, xa, lda1, K1, c0, D, scratch, brow, wide);
    for (int e = tid; e < R * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) {
        const float v = rnd<T>(scratch[r * CS + j]);
        scratch[r * CS + j] = v;
        if (agg_w) st(agg_w, (row0 + r) * D + c, v);
      }
    }
    __syncthreads();
    cs_to_a<R>(ga, lda2, c0, D, scratch);
  }

  rb_pass_wr<T, R>(ring, ga, lda2, D, cb, D2, scratch, w1, D2);
  for (int e = tid; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D2)
      st(mid, (row0 + r) * D2 + c,
         rnd<T>(fmaxf(scratch[r * CS + j] + b1[c], 0.f)));
  }
}

template <typename T>
__global__ void __launch_bounds__(RNT, 2)
k4f_out_kernel(const T* __restrict__ mid, const T* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ out, int D,
               int D2, int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const RbSmem L = k4f_out_smem<T>(D2, ring);
  T* ma = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of out
  const int lda = a_lda(D2);
  rows_to_a<R>(ma, lda, mid, row0, R, D2);
  rb_pass_wr<T, R>(ring, ma, lda, D2, cb, D, scratch, w2, D);
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D)
      st(out, (row0 + r) * D + c, rnd<T>(scratch[r * CS + j] + b2[c]));
  }
}

// K4f's f32 ring for its mid launch (0) or out launch (1): the 64 KB one,
// or the 32 KB one where that does not fit.
template <typename T>
static RbShape k4f_launch_shape(int launch, int S, int D, int D2) {
  return rb_shape(R, 1, [&](int, int rg) {
    return launch == 0 ? k4f_mid_smem<T>(S, D, rg).total
                       : k4f_out_smem<T>(D2, rg).total;
  });
}

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
// stream.
template <typename T>
__host__ __device__ inline RbSmem gine_bwd_dmid_smem(int D, int ring) {
  return rb_smem(0, 0, a_bytes<T>(R, D), 0, pass_bytes<T>(R, ring));
}

template <typename T>
__host__ __device__ inline RbSmem gine_bwd_dagg_smem(int D2, int ring) {
  return rb_smem(0, 0, a_bytes<T>(R, D2), 0, pass_bytes<T>(R, ring));
}

template <typename T, bool BN>
__global__ void __launch_bounds__(RNT, 2)
gine_bwd_dmid_kernel(const T* __restrict__ g, const float* __restrict__ ds,
                     const T* __restrict__ adj, const T* __restrict__ mid,
                     const T* __restrict__ out, const T* __restrict__ w2t,
                     T* __restrict__ gtc, T* __restrict__ dmidc,
                     int* __restrict__ strip_live,
                     float* __restrict__ partial, int S, int D, int D2,
                     int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int live;
  const RbSmem L = gine_bwd_dmid_smem<T>(D, ring);
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
        a4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) a_put<R>(ga, lda, r, c, v[r]);
    }
  }
  __syncthreads();
  if (first && tid == 0) strip_live[blockIdx.x] = live;
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

template <typename T>
__global__ void __launch_bounds__(RNT, 2)
gine_bwd_dagg_kernel(const T* __restrict__ dmidc, const T* __restrict__ w1t,
                     const int* __restrict__ strip_live,
                     T* __restrict__ daggc, int D, int D2, int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const RbSmem L = gine_bwd_dagg_smem<T>(D2, ring);
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
  const int lda = a_lda(D2);
  rows_to_a<R>(ma, lda, dmidc, row0, R, D2);
  rb_pass_wr<T, R>(ring, ma, lda, D2, cb, D, scratch, w1t, D);
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) st(daggc, (row0 + r) * D + c, scratch[r * CS + j]);
  }
}

// K1f: the dead blocks' constant row, the row-block kernel, then the
// fixed-order sum of the moment partials of its N / 16 strips. partial
// holds N / 16 + 1 rows of [2, D]: the last keeps the constant row.
template <typename T>
static int gine_bn_fwd(const void* h, const float* a, const float* b,
                       const void* adj, const void* cnt, const void* etab,
                       const void* w1, const float* b1, const void* w2,
                       const float* b2, void* out, void* agg, void* mid,
                       float* partial, float* sums, int T_, int S, int D,
                       int D2, int relu_in, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int N = T_ * S;
  const RbShape shape = k1f_launch_shape<T>(S, D, D2);
  if (!shape.rb) return (int)cudaErrorInvalidValue;
  const int nblk = (N + shape.rb - 1) / shape.rb;
  auto kernel = shape.rb == K1F_RB ? k1f_kernel<T, K1F_RB> : k1f_kernel<T, R>;
  cudaError_t e = set_smem(kernel, shape.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  float* dead_row = partial + (size_t)(N / R) * 2 * D;
  k1f_dead_row_kernel<T><<<(D + RNT - 1) / RNT, RNT, 0, st>>>(
      b1, (const T*)w2, b2, dead_row, D, D2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  kernel<<<nblk, RNT, shape.bytes, st>>>(
      (const T*)h, a, b, (const T*)adj, (const T*)cnt, (const T*)etab,
      (const T*)w1, b1, (const T*)w2, b2, (T*)out, (T*)agg, (T*)mid, partial,
      dead_row, N, S, D, D2, relu_in, shape.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return launch_sum_partials(partial, sums, N / R, 2 * D, st);
}

// K4f: the mid launch, then the out launch. mid is written in full (the
// caller's scratch when it wants no residuals); agg only when not null.
template <typename T>
static int gine_fwd(const void* h, const void* adj, const void* cnt,
                    const void* etab, const void* w1, const float* b1,
                    const void* w2, const float* b2, void* out, void* agg,
                    void* mid, int T_, int S, int D, int D2, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0 || !mid)
    return (int)cudaErrorInvalidValue;
  const int N = T_ * S;
  cudaStream_t st = (cudaStream_t)stream;
  const RbShape a = k4f_launch_shape<T>(0, S, D, D2);
  const RbShape b = k4f_launch_shape<T>(1, S, D, D2);
  if (!a.rb || !b.rb) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(k4f_mid_kernel<T>, a.bytes);
  if (e != cudaSuccess) return (int)e;
  k4f_mid_kernel<T><<<dim3(N / R, (D2 + RCW - 1) / RCW), RNT, a.bytes, st>>>(
      (const T*)h, (const T*)adj, (const T*)cnt, (const T*)etab,
      (const T*)w1, b1, (T*)agg, (T*)mid, S, D, D2, a.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = set_smem(k4f_out_kernel<T>, b.bytes)) != cudaSuccess) return (int)e;
  k4f_out_kernel<T><<<dim3(N / R, (D + RCW - 1) / RCW), RNT, b.bytes, st>>>(
      (const T*)mid, (const T*)w2, b2, (T*)out, D, D2, b.ring);
  return (int)cudaGetLastError();
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
// itself.
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
                    int tile_rows, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const int N = T_ * S, nstrip = N / R;
  cudaStream_t st = (cudaStream_t)stream;
  const RbShape sm = rb_shape_two([&](int, int rg) {
    return gine_bwd_dmid_smem<T>(D, rg).total;
  });
  const RbShape sa = rb_shape_two([&](int, int rg) {
    return gine_bwd_dagg_smem<T>(D2, rg).total;
  });
  if (!sm.rb || !sa.rb) return (int)cudaErrorInvalidValue;

  int err = launch_transpose<T>(w1, w1t, D, D2, st);
  if (err) return err;
  if ((err = launch_transpose<T>(w2, w2t, D2, D, st))) return err;

  cudaError_t e = set_smem(gine_bwd_dmid_kernel<T, BN>, sm.bytes);
  if (e != cudaSuccess) return (int)e;
  gine_bwd_dmid_kernel<T, BN>
      <<<dim3(nstrip, (D2 + RCW - 1) / RCW), RNT, sm.bytes, st>>>(
      (const T*)g, ds, (const T*)adj, (const T*)mid, (const T*)out,
      (const T*)w2t, (T*)gtc, (T*)dmidc, strip_live, part_rows, S, D, D2,
      sm.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = set_smem(gine_bwd_dagg_kernel<T>, sa.bytes)) != cudaSuccess)
    return (int)e;
  gine_bwd_dagg_kernel<T>
      <<<dim3(nstrip, (D + RCW - 1) / RCW), RNT, sa.bytes, st>>>(
      (const T*)dmidc, (const T*)w1t, strip_live, (T*)daggc, D, D2, sa.ring);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if constexpr (BN)
    err = launch_adj_pass<T>(
        daggc, adj,
        BnAdjoint<T>{(const T*)h, a, b, (T*)dh, nullptr, part_adj, D,
                     relu_in},
        N, S, D, st);
  else
    err = launch_adj_pass<T>(daggc, adj, AdjStore<T>{(T*)dh, D}, N, S, D,
                             st);
  if (err) return err;

  const int width = 2 * D * D2 + CNT_PAD * D;
  const WProb p[3] = {{agg, dmidc, D, D2, 0},
                      {mid, BN ? (const void*)gtc : g, D2, D, D * D2},
                      {cnt, daggc, CNT_PAD, D, 2 * D * D2}};
  err = launch_wgrad<T>(p, 3, strip_live, N, rows_per_chunk, chunks,
                        tile_rows, part_w, width, st);
  if (err) return err;

  if ((err = launch_sum_partials(part_rows, sums_rows, nstrip, D2 + D, st)))
    return err;
  if constexpr (BN) {
    err = launch_sum_partials(part_adj, sums_adj, nstrip, 2 * D, st);
    if (err) return err;
  }
  return launch_sum_partials(part_w, wgrad, chunks, width, st);
}

}  // namespace fbl

extern "C" {

// K1f: gine_bn_fwd_*, and the rows per block it launches with at a shape
// (0 where it cannot launch), which the plan of what it skips needs.
#define GINE_BN_FWD(suffix, T)                                              \
  int gine_bn_fwd_##suffix(const void* h, const float* a, const float* b,   \
                           const void* adj, const void* cnt,                \
                           const void* etab, const void* w1,                \
                           const float* b1, const void* w2,                 \
                           const float* b2, void* out, void* agg, void* mid, \
                           float* partial, float* sums, int T_, int S,      \
                           int D, int D2, int relu_in, void* stream) {      \
    return fbl::gine_bn_fwd<T>(h, a, b, adj, cnt, etab, w1, b1, w2, b2,     \
                               out, agg, mid, partial, sums, T_, S, D, D2,  \
                               relu_in, stream);                            \
  }                                                                         \
  int gine_bn_fwd_rows_##suffix(int S, int D, int D2) {                     \
    return fbl::k1f_launch_shape<T>(S, D, D2).rb;                          \
  }

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
                                  tile_rows, stream);                       \
  }

// K4f: out (and the residual agg when not null; mid always, scratch when
// the caller wants no residuals) of the unchained layer.
#define GINE_FWD(suffix, T)                                                 \
  int gine_fwd_##suffix(const void* h, const void* adj, const void* cnt,    \
                        const void* etab, const void* w1, const float* b1,  \
                        const void* w2, const float* b2, void* out,         \
                        void* agg, void* mid, int T_, int S, int D, int D2, \
                        void* stream) {                                     \
    return fbl::gine_fwd<T>(h, adj, cnt, etab, w1, b1, w2, b2, out, agg,    \
                            mid, T_, S, D, D2, stream);                     \
  }

// K4b: dh, [db1 | db2] and [dW1 | dW2 | detab] of the unchained layer.
#define GINE_BWD(suffix, T)                                                 \
  int gine_bwd_##suffix(const void* g, const void* adj, const void* cnt,    \
                        const void* agg, const void* mid, const void* w1,   \
                        const void* w2, void* w1t, void* w2t, void* dmidc,  \
                        void* daggc, int* strip_live, float* part_rows,     \
                        float* part_w, void* dh, float* sums_rows,          \
                        float* wgrad, int T_, int S, int D, int D2,         \
                        int chunks, int rows_per_chunk, int tile_rows,      \
                        void* stream) {                                     \
    return fbl::gine_bwd<T, false>(                                         \
        g, nullptr, nullptr, nullptr, nullptr, adj, cnt, agg, mid, nullptr, \
        w1, w2, w1t, w2t, nullptr, dmidc, daggc, strip_live, part_rows,     \
        nullptr, part_w, dh, sums_rows, nullptr, wgrad, T_, S, D, D2, 0,    \
        chunks, rows_per_chunk, tile_rows, stream);                         \
  }

GINE_BN_FWD(f32, float)
GINE_BN_FWD(bf16, __nv_bfloat16)
GINE_BN_BWD(f32, float)
GINE_BN_BWD(bf16, __nv_bfloat16)
GINE_FWD(f32, float)
GINE_FWD(bf16, __nv_bfloat16)
GINE_BWD(f32, float)
GINE_BWD(bf16, __nv_bfloat16)

}  // extern "C"
