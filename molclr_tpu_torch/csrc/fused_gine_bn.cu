// K1f and K4f: the fused GINE layers' forwards, BN-chained (K1f) and
// unchained (K4f), for sm_90a; their backwards K1b and K4b are in
// fused_gine_bwd.cu (its own library, so that the two build in parallel).
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
// K4f replaces molclr_tpu/ops/fused_layer.py:_fwd_kernel, the unchained
// layer fused_gine_layer that the fine-tuning trunk runs (drop_ratio > 0:
// BatchNorm, relu and dropout run outside):
//   agg = rnd(A @ h + cnt @ etab), mid = rnd(relu(agg @ W1 + b1)),
//   out = rnd(mid @ W2 + b2), with agg and mid written as residuals.
// Its backward K4b, and K1b, are in fused_gine_bwd.cu.
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
//
// Where not even a 16-row block holds mid [16, D2] beside agg (f32 above
// about D = 1,037 at S = 128, bf16 about D2 = 4,000), K1f splits into the
// streamed design that K4f takes where its mid launch cannot hold agg
// (gine_bn_fwd_split): agg_kernel writes agg to device memory (the
// caller's scratch without residuals), the mid launch (k4f_out_kernel with
// RELU) streams it in K-chunks and writes mid (scratch likewise), and
// k1f_out_kernel, one block per (16-row strip, 128-column slice), computes
// out = rnd(mid @ W2 + b2) with mid streamed through shared memory in
// K-chunks where it does not fit whole (rb_pass_streamed), and the strip's
// moment partials for its columns in stage 3's order. Dead rows run the
// products on agg = 0, which in f32 gives the dead row's bits (one thread's
// sum from 0 over k ascending).
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

// The split K1f's out launch (k1f_out_kernel) where k1f_launch_shape finds
// no block; rb = 0 where it cannot launch.
template <typename T>
static RbShape k1f_out_shape(int D2) {
  return rb_stream(D2, [&](int ka) {
    return rb_shape(R, 1, [&](int, int rg) {
      return row_operand_smem<T>(ka, rg).total;
    });
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

// The split K1f's out launch: out = rnd(mid @ W2 + b2) for the strip's
// slice of columns, mid held whole or (STREAM) ka columns at a time, and the
// strip's moment partials [sum m out, sum m out^2] of the cast out for
// those columns at row blockIdx.x of partial [N / 16, 2 D], each group of
// four rows summed, then the groups in order (stage 3's order).
template <typename T, bool STREAM>
__global__ void __launch_bounds__(RNT, 2)
k1f_out_kernel(const T* __restrict__ mid, const T* __restrict__ adj,
               const T* __restrict__ w2, const float* __restrict__ b2,
               T* __restrict__ out, float* __restrict__ partial, int S, int D,
               int D2, int ring, int ka) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const RbSmem L = row_operand_smem<T>(STREAM ? ka : D2, ring);
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* ma = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of out
  if (tid < R) {
    const size_t r = row0 + tid;
    msk[tid] = ld(adj, r * S + r % S) > 0.f ? 1.f : 0.f;
  }
  rb_pass_streamed<T, R, STREAM>(ring, ka, ma, mid, row0, R, D2, cb, D,
                                 scratch, w2, D);
  for (int e = tid; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) {
      const float v = rnd<T>(scratch[r * CS + j] + b2[c]);
      scratch[r * CS + j] = v;
      st(out, (row0 + r) * D + c, v);
    }
  }
  __syncthreads();
  const int c = cb + tid;
  if (tid < RCW && c < D) {
    float t0 = 0.f, t1 = 0.f;
    for (int w = 0; w < 4; ++w) {
      float s0 = 0.f, s1 = 0.f;
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * w + i;
        const float v = scratch[r * CS + tid], ob = v * msk[r];
        s0 += ob;
        s1 += ob * v;
      }
      t0 += s0;
      t1 += s1;
    }
    float* prow = partial + (size_t)blockIdx.x * 2 * D;
    prow[c] = t0;
    prow[D + c] = t1;
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
//     Where [16, D2] mid rows do not fit in shared memory (f32 above about
//     D2 = 3,000) they stream in K-chunks (rb_pass_streamed).
// Where the mid launch cannot hold agg [16, D] beside its adjacency operand
// (f32 above about D = 2,752 at S = 256), agg_kernel writes agg to device
// memory and the mid launch is k4f_out_kernel with RELU, which streams agg
// in K-chunks as the out launch streams mid (k4f_launch_shape, launch 2).
// Members (MEM, where M > 1). Grid z is the member m of a stack of M
// layers that share the adjacency and the counts (the JAX package's
// vmapped pallas_call over a seed / target ensemble): h, etab, W1, b1, W2,
// b2, agg, mid and out are m's, N x D, CNT_PAD x D, D x D2, D2, D2 x D, D,
// N x D, N x D2 and N x D elements apart, and m's blocks do the one-layer
// launch's arithmetic; the one-layer instantiation (not MEM) compiles
// without the member offsets.
template <typename T>
__host__ __device__ inline RbSmem k4f_mid_smem(int S, int D, int ring) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(R, nch * ACW + CNT_PAD),
                 a_bytes<T>(R, D), pass_bytes<T>(R, ring));
}

// (two blocks an SM by registers; shared memory decides the rest)
template <typename T, bool MEM>
__global__ void __launch_bounds__(RNT, 2)
k4f_mid_kernel(const T* __restrict__ h, const T* __restrict__ adj,
               const T* __restrict__ cnt, const T* __restrict__ etab,
               const T* __restrict__ w1, const float* __restrict__ b1,
               T* __restrict__ agg_out, T* __restrict__ mid, int S, int D,
               int D2, int ring) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int cnt_live;
  if constexpr (MEM) {  // member blockIdx.z (N = gridDim.x * 16 rows)
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    h += z * N * D;
    etab += z * CNT_PAD * D;
    w1 += z * D * D2;
    b1 += z * D2;
    mid += z * N * D2;
    if (agg_out) agg_out += z * N * D;
  }
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

// out = rnd(mid @ W2 + b2), [N, D2] @ [D2, D]; with RELU the streamed
// designs' mid launch, mid = rnd(relu(agg @ W1 + b1)): the same pass on
// (agg, W1, b1, mid) with D2 for D and D for D2.
template <typename T, bool MEM, bool STREAM, bool RELU = false>
__global__ void __launch_bounds__(RNT, 2)
k4f_out_kernel(const T* __restrict__ mid, const T* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ out, int D,
               int D2, int ring, int ka) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  if constexpr (MEM) {  // member blockIdx.z
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    mid += z * N * D2;
    w2 += z * D2 * D;
    b2 += z * D;
    out += z * N * D;
  }
  const RbSmem L = row_operand_smem<T>(STREAM ? ka : D2, ring);
  T* ma = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of out
  rb_pass_streamed<T, R, STREAM>(ring, ka, ma, mid, row0, R, D2, cb, D,
                                 scratch, w2, D);
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if constexpr (RELU) {
      if (c < D)
        st(out, (row0 + r) * D + c,
           rnd<T>(fmaxf(scratch[r * CS + j] + b2[c], 0.f)));
    } else {
      if (c < D)
        st(out, (row0 + r) * D + c, rnd<T>(scratch[r * CS + j] + b2[c]));
    }
  }
}

// K4f's f32 ring for its mid launch (0), out launch (1) or streamed mid
// launch (2): the 64 KB one, or the 32 KB one where that does not fit; the
// out launch streams mid, the streamed mid launch agg, in K-chunks where
// neither fits it whole. Launch 0 has rb = 0 where agg does not fit beside
// its operand: then the streamed designs run.
template <typename T>
static RbShape k4f_launch_shape(int launch, int S, int D, int D2) {
  if (launch == 0)
    return rb_shape(R, 1, [&](int, int rg) {
      return k4f_mid_smem<T>(S, D, rg).total;
    });
  return rb_stream(launch == 1 ? D2 : D, [&](int ka) {
    return rb_shape(R, 1, [&](int, int rg) {
      return row_operand_smem<T>(ka, rg).total;
    });
  });
}

// The streamed designs' agg launch (K4f's where its mid launch cannot hold
// agg [16, D], the split K1f's): one block of RNT
// threads per (16-row strip, 128-column slice of agg) computes its slice
// agg = rnd([A live chunks | cnt] @ [y ; etab]), y = rnd(relu?(h a + b))
// (PRO: K1f's prologue) or h (K4f), over the strip's live 32-column chunks,
// and writes it to device memory, from which the mid launch streams it. A
// strip whose A and cnt rows are all zero writes zeros with no product. In
// f32 each output is one thread's sum over k in ascending order, as stage 1
// of k1f_kernel and k4f_mid_kernel sum it. Members (MEM, K4f) as
// k4f_mid_kernel: h, etab and agg per member, adj and cnt shared.
template <typename T>
__host__ __device__ inline RbSmem agg_smem(int S) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(R, nch * ACW + CNT_PAD), 0,
                 chunk_bytes<T>(R));
}

template <typename T, bool PRO, bool MEM>
__global__ void __launch_bounds__(RNT, 2)
agg_kernel(const T* __restrict__ h, const float* __restrict__ a,
           const float* __restrict__ b, const T* __restrict__ adj,
           const T* __restrict__ cnt, const T* __restrict__ etab,
           T* __restrict__ agg, int S, int D, int relu_in) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int cnt_live;
  if constexpr (MEM) {  // member blockIdx.z
    const size_t z = blockIdx.z, N = (size_t)gridDim.x * R;
    h += z * N * D;
    etab += z * CNT_PAD * D;
    agg += z * N * D;
  }
  const RbSmem L = agg_smem<T>(S);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  int* knode = width + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* xa = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice of agg
  const bool clive = cnt_rows_live(cnt, row0, R, &cnt_live);
  const int nlive = adj_live_chunks(adj, row0, R, S, flags, node, width,
                                    msk);
  if (nlive == 0 && !clive) {
    for (int e = threadIdx.x; e < R * RCW; e += RNT) {
      const int r = e / RCW, c = cb + e % RCW;
      if (c < D) st(agg, (row0 + r) * D + c, 0.f);
    }
    return;
  }
  const int KL = nlive * ACW, K1 = KL + CNT_PAD, lda = a_lda(K1);
  adj_operand<R>(adj, cnt, row0, R, S, nlive, node, width, knode, xa, lda);
  auto load = [&](int k, int c) -> T {
    const T* p =
        k < KL ? h + (size_t)knode[k] * D : etab + (size_t)(k - KL) * D;
    return p[c];
  };
  auto xf = [&](int c) {
    const float ac = PRO ? a[c] : 1.f, bc = PRO ? b[c] : 0.f;
    return [=](int k, float v) -> float {
      return PRO && k < KL ? rnd<T>(prologue(v, ac, bc, relu_in)) : v;
    };
  };
  rb_pass<T, R>(xa, lda, K1, cb, D, scratch, load, xf);
  for (int e = threadIdx.x; e < R * RCW; e += RNT) {
    const int r = e / RCW, j = e % RCW, c = cb + j;
    if (c < D) st(agg, (row0 + r) * D + c, scratch[r * CS + j]);
  }
}

// The streamed designs' agg launch, then their mid launch mid = rnd(relu(agg
// @ W1 + b1)) with agg streamed in K-chunks where [16, D] of it do not fit
// in shared memory (k4f_launch_shape, launch 2), for M members (PRO: K1f,
// one member).
template <typename T, bool PRO>
static int agg_then_mid(const void* h, const float* a, const float* b,
                        const void* adj, const void* cnt, const void* etab,
                        const void* w1, const float* b1, void* agg, void* mid,
                        int N, int S, int D, int D2, int relu_in, int M,
                        cudaStream_t st) {
  const size_t bytes = agg_smem<T>(S).total;
  const RbShape sm = k4f_launch_shape<T>(2, S, D, D2);
  if (!agg || !mid || bytes > max_smem() || !sm.rb)
    return (int)cudaErrorInvalidValue;
  auto aggk = M > 1 ? agg_kernel<T, PRO, !PRO> : agg_kernel<T, PRO, false>;
  cudaError_t e = set_smem(aggk, bytes);
  if (e != cudaSuccess) return (int)e;
  aggk<<<dim3(N / R, (D + RCW - 1) / RCW, M), RNT, bytes, st>>>(
      (const T*)h, a, b, (const T*)adj, (const T*)cnt, (const T*)etab,
      (T*)agg, S, D, relu_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  auto midk = M > 1 ? (sm.ka ? k4f_out_kernel<T, !PRO, true, true>
                             : k4f_out_kernel<T, !PRO, false, true>)
                    : (sm.ka ? k4f_out_kernel<T, false, true, true>
                             : k4f_out_kernel<T, false, false, true>);
  if ((e = set_smem(midk, sm.bytes)) != cudaSuccess) return (int)e;
  midk<<<dim3(N / R, (D2 + RCW - 1) / RCW, M), RNT, sm.bytes, st>>>(
      (const T*)agg, (const T*)w1, b1, (T*)mid, D2, D, sm.ring, sm.ka);
  return (int)cudaGetLastError();
}

// K1f where no block fits (k1f_launch_shape): agg_then_mid (agg and mid
// not null: the caller's scratch without residuals), k1f_out_kernel out and
// the partials, then the fixed-order sum of the partials of its N / 16
// strips.
template <typename T>
static int gine_bn_fwd_split(const void* h, const float* a, const float* b,
                             const void* adj, const void* cnt,
                             const void* etab, const void* w1,
                             const float* b1, const void* w2,
                             const float* b2, void* out, void* agg, void* mid,
                             float* partial, float* sums, int N, int S,
                             int D, int D2, int relu_in, cudaStream_t st) {
  const RbShape sb = k1f_out_shape<T>(D2);
  if (!sb.rb) return (int)cudaErrorInvalidValue;
  const int err = agg_then_mid<T, true>(h, a, b, adj, cnt, etab, w1, b1, agg,
                                        mid, N, S, D, D2, relu_in, 1, st);
  if (err) return err;
  auto outk = sb.ka ? k1f_out_kernel<T, true> : k1f_out_kernel<T, false>;
  cudaError_t e = set_smem(outk, sb.bytes);
  if (e != cudaSuccess) return (int)e;
  outk<<<dim3(N / R, (D + RCW - 1) / RCW), RNT, sb.bytes, st>>>(
      (const T*)mid, (const T*)adj, (const T*)w2, b2, (T*)out, partial, S, D,
      D2, sb.ring, sb.ka);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return launch_sum_partials(partial, sums, N / R, 2 * D, st);
}

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
  cudaStream_t st = (cudaStream_t)stream;
  // the dead blocks' constant row, the row-block kernel, then the
  // fixed-order sum of the moment partials of its N / 16 strips; partial
  // holds N / 16 + 1 rows of [2, D]: the last keeps the constant row
  const RbShape shape = k1f_launch_shape<T>(S, D, D2);
  if (!shape.rb)
    return gine_bn_fwd_split<T>(h, a, b, adj, cnt, etab, w1, b1, w2, b2, out,
                                agg, mid, partial, sums, N, S, D, D2,
                                relu_in, st);
  const int nblk = (N + shape.rb - 1) / shape.rb;
  auto kernel = shape.rb == K1F_RB ? k1f_kernel<T, K1F_RB> : k1f_kernel<T, R>;
  cudaError_t e = set_smem(kernel, shape.bytes);
  if (e != cudaSuccess) return (int)e;
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

// K4f of M members (stacked as k4f_mid_kernel says; M = 1: one layer):
// the mid launch (or where it cannot hold agg, agg_then_mid), then the out
// launch. mid is written in full (the caller's scratch when it wants no
// residuals); agg only when not null, which it must not be where agg goes
// through device memory (gine_streams_agg_*).
template <typename T>
static int gine_fwd(const void* h, const void* adj, const void* cnt,
                    const void* etab, const void* w1, const float* b1,
                    const void* w2, const float* b2, void* out, void* agg,
                    void* mid, int T_, int S, int D, int D2, int M,
                    void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0 || M <= 0 || !mid)
    return (int)cudaErrorInvalidValue;
  const int N = T_ * S;
  cudaStream_t st = (cudaStream_t)stream;
  const RbShape a = k4f_launch_shape<T>(0, S, D, D2);
  const RbShape b = k4f_launch_shape<T>(1, S, D, D2);
  if (!b.rb) return (int)cudaErrorInvalidValue;
  const bool mem = M > 1;
  auto outk = mem ? (b.ka ? k4f_out_kernel<T, true, true>
                          : k4f_out_kernel<T, true, false>)
                  : (b.ka ? k4f_out_kernel<T, false, true>
                          : k4f_out_kernel<T, false, false>);
  cudaError_t e;
  if (a.rb) {
    auto midk = mem ? k4f_mid_kernel<T, true> : k4f_mid_kernel<T, false>;
    if ((e = set_smem(midk, a.bytes)) != cudaSuccess) return (int)e;
    midk<<<dim3(N / R, (D2 + RCW - 1) / RCW, M), RNT, a.bytes, st>>>(
        (const T*)h, (const T*)adj, (const T*)cnt, (const T*)etab,
        (const T*)w1, b1, (T*)agg, (T*)mid, S, D, D2, a.ring);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  } else {
    const int err = agg_then_mid<T, false>(h, nullptr, nullptr, adj, cnt,
                                           etab, w1, b1, agg, mid, N, S, D,
                                           D2, 0, M, st);
    if (err) return err;
  }
  if ((e = set_smem(outk, b.bytes)) != cudaSuccess) return (int)e;
  outk<<<dim3(N / R, (D + RCW - 1) / RCW, M), RNT, b.bytes, st>>>(
      (const T*)mid, (const T*)w2, b2, (T*)out, D, D2, b.ring, b.ka);
  return (int)cudaGetLastError();
}

}  // namespace fbl

extern "C" {

// K1f: gine_bn_fwd_*, the rows per block it launches with at a shape (0
// where it cannot launch), which the plan of what it skips needs, and
// whether it takes the split design there (1: agg and mid must not be
// null). gine_streams_agg_*: whether K4f takes the streamed design at a
// shape, which writes agg through device memory (1: agg must not be null).
#define GINE_BN_FWD(suffix, T)                                              \
  int gine_bn_fwd_split_##suffix(int S, int D, int D2) {                    \
    return !fbl::k1f_launch_shape<T>(S, D, D2).rb &&                        \
           fbl::k1f_out_shape<T>(D2).rb &&                                  \
           fbl::k4f_launch_shape<T>(2, S, D, D2).rb;                        \
  }                                                                         \
  int gine_streams_agg_##suffix(int S, int D, int D2) {                     \
    return fbl::k4f_launch_shape<T>(0, S, D, D2).rb == 0;                   \
  }                                                                         \
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
    const int rb = fbl::k1f_launch_shape<T>(S, D, D2).rb;                  \
    return rb ? rb : gine_bn_fwd_split_##suffix(S, D, D2) ? fbl::R : 0;     \
  }

// K4f: out (and the residual agg when not null; mid always, scratch when
// the caller wants no residuals) of the unchained layer, for M members
// stacked along the first axis of every argument but adj and cnt (M = 1:
// one layer).
#define GINE_FWD(suffix, T)                                                 \
  int gine_fwd_##suffix(const void* h, const void* adj, const void* cnt,    \
                        const void* etab, const void* w1, const float* b1,  \
                        const void* w2, const float* b2, void* out,         \
                        void* agg, void* mid, int T_, int S, int D, int D2, \
                        int M, void* stream) {                              \
    return fbl::gine_fwd<T>(h, adj, cnt, etab, w1, b1, w2, b2, out, agg,    \
                            mid, T_, S, D, D2, M, stream);                  \
  }

GINE_BN_FWD(f32, float)
GINE_BN_FWD(bf16, __nv_bfloat16)
GINE_FWD(f32, float)
GINE_FWD(bf16, __nv_bfloat16)

}  // extern "C"
