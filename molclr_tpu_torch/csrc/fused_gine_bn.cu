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
// Design (see fused_bn_common.cuh): one block of 128 threads per 16-row
// strip of a tile. The block keeps [A strip | cnt rows] (then mid, in the
// same space) and agg in shared memory as f32, streams [y ; etab], W1 and
// W2 through a 32 x 128 chunk staged one chunk ahead in registers. Shared
// memory at S = 256, D = 300: (max(16*272, 16*600) + 16*300 + 32*128 + 16)
// floats = 74 KB, three blocks per SM, so the 288 blocks of the embed
// shape run in one wave.
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
// What the simple design leaves on the table: no tensor cores (wgmma) and
// no TMA; a 4 x 4 register tile reads 8 shared words per 16 FMA, so the
// shared-memory rate caps the products at about half the FMA rate; the
// dense A strip multiplies mostly zeros; padded rows (half of a batch) are
// computed in full; the prologue and y are recomputed by each of a tile's
// 16 strips; W1 and W2 are re-read from L2 by each of the 288 blocks.
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
// its sequential grid. Here dx for a strip needs daggc for all 256 rows of
// its tile, which a strip block does not have, so the backward is three
// passes, each deterministic:
//   (a) rows: per strip, gt, dmid, dagg (row-local; gtc and dmidc live in
//       shared memory; W2^T and W1^T, transposed once per backward so that
//       they stream row by row, go through the chunk), writing gtc, dmidc,
//       daggc to scratch and the strip's db1 / db2 partials;
//   (b) adjacency: per strip, dx = A_strip @ daggc_tile and the prologue
//       adjoint, writing dh and the strip's da / db partials;
//   (c) weights: dW1, dW2 and detab as transposed-left products over N
//       (atb_kernel), the rows split in fixed chunks;
// and every partial is added in a fixed order (sum_partials). No atomics:
// two runs are bit-identical.
//
// Bound on the H100 at the pretraining shape (T = 22, D = 300, 4,696 real
// rows of 5,632, f32): four dense products over the real rows, 4 x 2 x
// 4,696 x 300 x 600 = 6.8 GFLOP, plus A @ daggc and cnt^T daggc by their
// nonzeros, against about 40 MB moved: 0.10 ms at 67 TFLOP/s. In bf16 the
// bytes set the bound (about 7 us). The same simple design as K1f, so the
// same things are left on the table; the weight products read agg, mid,
// gtc and dmidc back from device memory (the TPU kernel has them in VMEM).

// K4f and K4b replace molclr_tpu/ops/fused_layer.py:_fwd_kernel and
// _bwd_kernel, the unchained layer fused_gine_layer that the fine-tuning
// trunk runs (drop_ratio > 0: BatchNorm, relu and dropout run outside):
//   agg = rnd(A @ h + cnt @ etab), mid = rnd(relu(agg @ W1 + b1)),
//   out = rnd(mid @ W2 + b2), with agg and mid written as residuals;
//   dmid = (g @ W2^T) * [mid > 0], dagg = rnd(rnd(dmid) @ W1^T),
//   dh = rnd(A @ daggc), dW1 = agg^T dmidc, db1 = sum dmid,
//   dW2 = mid^T g, db2 = sum g, detab = cnt^T daggc.
// They are the same strip kernels instantiated with BN = false: no
// prologue, no moment epilogue, gt = g with no dsums term, no prologue
// adjoint. Nothing of BatchNorm is computed, where feeding K1f identity
// coefficients would compute the moments and throw them away. K4b keeps
// K1b's three deterministic passes and its W^T transposes.
//
// Bound on the H100 at the fine-tuning shape (a 32-molecule batch with
// hydrogens: T = 4 tiles of 256, 619 real rows, D = 300, f32): K4f 0.45
// GFLOP (the two MLP products over the real rows; the adjacency and counts
// by their nonzeros add 2 MFLOP) against 8.7 MB moved (h, out, agg, mid,
// A, W1, W2): 6.7 us by operations; K4b twice the operations, 13 us. In
// bf16 K4f is bound by its 4.4 MB, 1.3 us. What bounds this kernel in
// practice is the shape: 64 strip blocks on 132 SMs, one partial wave, so
// a launch takes about one block's latency (a 16-row strip through three
// products on CUDA cores); the design leaves the card mostly idle at this
// batch size, and takes no tensor cores, as K1f.

#include "fused_bn_common.cuh"

namespace fbl {

// BN selects the kernel: true for K1f / K1b (prologue, moments and their
// adjoints), false for K4f / K4b, the unchained layer of the fine-tuning
// trunk (the same strips without the prologue, the moment epilogue, gt's
// dsums term and the prologue adjoint: nothing of BatchNorm is computed).
template <typename T, bool BN>
__global__ void __launch_bounds__(NT)
gine_fwd_kernel(const T* __restrict__ h, const float* __restrict__ a,
                const float* __restrict__ b, const T* __restrict__ adj,
                const T* __restrict__ cnt, const T* __restrict__ etab,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                T* __restrict__ out, T* __restrict__ agg_out,
                T* __restrict__ mid_out, float* __restrict__ partial, int S,
                int D, int D2, int relu_in) {
  extern __shared__ float smem[];
  const int strips = S / R;
  const int tile = blockIdx.x / strips, strip = blockIdx.x % strips;
  const int KA = S + CNT_PAD;
  const size_t node0 = (size_t)tile * S;       // first node of the tile
  const size_t row0 = node0 + (size_t)strip * R;
  float* ext = smem;                           // [R, KA] A strip | cnt
  float* mid = smem;                           // [R, D2], ext is dead then
  float* agg = smem + max(R * KA, R * D2);     // [R, D]
  float* Bs = agg + R * D;                     // [KC, CW], epilogue scratch
  float* msk = Bs + KC * CW;                   // [R]

  load_adj_strip(adj, cnt, tile, strip, S, ext, msk);

  // agg = [A | cnt] @ [y ; etab], y = rnd(relu?(h * a + b)) (K1f) or h (K4f)
  strip_gemm(
      ext, KA, KA, D, Bs,
      [&](int k, int c) -> T {
        return k < S ? h[(node0 + k) * D + c] : etab[(size_t)(k - S) * D + c];
      },
      [&](int k, int c, float v) -> float {
        if constexpr (BN)
          return k < S ? rnd<T>(prologue(v, a[c], b[c], relu_in)) : v;
        else
          return v;
      },
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < D) {
              const float v = rnd<T>(acc[i][j]);
              agg[(warp * TM + i) * D + c] = v;
              if (agg_out) st(agg_out, (row0 + warp * TM + i) * D + c, v);
            }
          }
      });

  // mid = relu(agg @ W1 + b1)
  strip_gemm(
      agg, D, D, D2, Bs,
      [&](int k, int c) -> T { return w1[(size_t)k * D2 + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < D2) {
              const float v = rnd<T>(fmaxf(acc[i][j] + b1[c], 0.f));
              mid[(warp * TM + i) * D2 + c] = v;
              if (mid_out) st(mid_out, (row0 + warp * TM + i) * D2 + c, v);
            }
          }
      });

  // out = mid @ W2 + b2, and (K1f) the masked moments of the cast out
  strip_gemm(
      mid, D2, D2, D, Bs,
      [&](int k, int c) -> T { return w2[(size_t)k * D + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        if constexpr (BN) {
          moment_epilogue<T>(c0, acc, b2, out, row0, D, msk, Bs, partial);
        } else {
          const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int c = c0 + lane + 32 * j;
              if (c < D)
                st(out, (row0 + warp * TM + i) * D + c, acc[i][j] + b2[c]);
            }
        }
      });
}

// Backward pass (a): gt, dmid, dagg for one strip (row-local). w1t [D2, D]
// and w2t [D, D2] are W1^T and W2^T, so that the chunks stream row by row.
// K4b (BN false) takes gt = g itself: no gtc is written, and ds, adj, out
// and gtc are not read.
template <typename T, bool BN>
__global__ void __launch_bounds__(NT)
gine_bwd_rows_kernel(const T* __restrict__ g, const float* __restrict__ ds,
                     const T* __restrict__ adj, const T* __restrict__ mid,
                     const T* __restrict__ out, const T* __restrict__ w1t,
                     const T* __restrict__ w2t, T* __restrict__ gtc,
                     T* __restrict__ dmidc, T* __restrict__ daggc,
                     float* __restrict__ partial, int S, int D, int D2) {
  extern __shared__ float smem[];
  const int strips = S / R;
  const int tile = blockIdx.x / strips, strip = blockIdx.x % strips;
  const size_t row0 = (size_t)tile * S + (size_t)strip * R;
  float* gts = smem;             // [R, D]  gtc
  float* dms = gts + R * D;      // [R, D2] dmidc
  float* Bs = dms + R * D2;      // [KC, CW], epilogue scratch
  float* msk = Bs + KC * CW;     // [R]
  float* prow = partial + (size_t)blockIdx.x * (D2 + D);  // [db1 | db2]

  if constexpr (BN) {
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      msk[r] = ld(adj, (row0 + r) * S + strip * R + r) > 0.f ? 1.f : 0.f;
    }
    __syncthreads();
  }
  // K1b: gt = g + m (ds0 + 2 out ds1), each operation rounded as the plain
  // version rounds it; K4b: gt = g. db2 = sum gt over the strip (uncast).
  // (strip_gemm's first __syncthreads orders the gts writes before reads.)
  for (int c = threadIdx.x; c < D; c += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) {
      const size_t i = (row0 + r) * D + c;
      float v;
      if constexpr (BN) {
        const float t =
            __fadd_rn(ds[c], __fmul_rn(2.f * ld(out, i), ds[D + c]));
        const float gt = __fadd_rn(ld(g, i), msk[r] * t);
        s += gt;
        v = rnd<T>(gt);
        st(gtc, i, v);
      } else {
        v = ld(g, i);
        s += v;
      }
      gts[r * D + c] = v;
    }
    prow[D2 + c] = s;
  }

  // dmid = (gtc @ W2^T) * [mid > 0]; db1 = sum dmid (uncast)
  strip_gemm(
      gts, D, D, D2, Bs,
      [&](int k, int c) -> T { return w2t[(size_t)k * D2 + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        float s[1][TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) s[0][j] = 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = warp * TM + i;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < D2) {
              const size_t idx = (row0 + r) * D2 + c;
              const float dm = ld(mid, idx) > 0.f ? acc[i][j] : 0.f;
              s[0][j] += dm;
              const float v = rnd<T>(dm);
              dms[r * D2 + c] = v;
              st(dmidc, idx, v);
            }
          }
        }
        float* const dst[1] = {prow};
        colsum_epilogue<1>(c0, s, D2, Bs, dst);
      });

  // dagg = dmidc @ W1^T
  strip_gemm(
      dms, D2, D2, D, Bs,
      [&](int k, int c) -> T { return w1t[(size_t)k * D + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < D)
              st(daggc, (row0 + warp * TM + i) * D + c, rnd<T>(acc[i][j]));
          }
      });
}

// Backward pass (b): dx = A_strip @ daggc_tile. K1b then applies the
// prologue adjoint and writes dh and the strip's [da | db] partials; K4b
// writes dh = rnd(dx) (h, a, b and partial are not read).
template <typename T, bool BN>
__global__ void __launch_bounds__(NT)
gine_bwd_adj_kernel(const T* __restrict__ daggc, const T* __restrict__ h,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const T* __restrict__ adj, T* __restrict__ dh,
                    float* __restrict__ partial, int S, int D, int relu_in) {
  extern __shared__ float smem[];
  const int strips = S / R;
  const int tile = blockIdx.x / strips, strip = blockIdx.x % strips;
  const size_t node0 = (size_t)tile * S;
  const size_t row0 = node0 + (size_t)strip * R;
  float* As = smem;              // [R, S]
  float* Bs = As + R * S;        // [KC, CW], epilogue scratch
  float* msk = Bs + KC * CW;     // [R]

  load_a_strip(adj, tile, strip, S, As, msk);
  strip_gemm(
      As, S, S, D, Bs,
      [&](int k, int c) -> T { return daggc[(node0 + k) * D + c]; },
      Identity(),
      [&](int c0, float (&acc)[TM][TN]) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        if constexpr (BN) {
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
                const float hf = ld(h, r * D + c);
                const float dx = acc[i][j];
                const float dpre =
                    (!relu_in || prologue(hf, a[c], b[c], 0) > 0.f) ? dx
                                                                    : 0.f;
                st(dh, r * D + c, __fmul_rn(dpre, a[c]));
                s[0][j] += dpre * hf;
                s[1][j] += dpre;
              }
            }
          }
          float* prow = partial + (size_t)blockIdx.x * 2 * D;
          float* const dst[2] = {prow, prow + D};
          colsum_epilogue<2>(c0, s, D, Bs, dst);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int c = c0 + lane + 32 * j;
              if (c < D) st(dh, (row0 + warp * TM + i) * D + c, acc[i][j]);
            }
        }
      });
}

// K1f (BN) or K4f: the strip kernel and, for K1f, the fixed-order sum of
// the moment partials. a, b, partial and sums are null for K4f.
template <typename T, bool BN>
static int gine_fwd(const void* h, const float* a, const float* b,
                    const void* adj, const void* cnt, const void* etab,
                    const void* w1, const float* b1, const void* w2,
                    const float* b2, void* out, void* agg, void* mid,
                    float* partial, float* sums, int T_, int S, int D, int D2,
                    int relu_in, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int nblk = T_ * (S / R);
  const int region = R * (S + CNT_PAD) > R * D2 ? R * (S + CNT_PAD) : R * D2;
  const size_t floats = (size_t)region + R * D + KC * CW + R;
  const size_t bytes = floats * sizeof(float);
  cudaError_t e = set_smem(gine_fwd_kernel<T, BN>, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  gine_fwd_kernel<T, BN><<<nblk, NT, bytes, st>>>(
      (const T*)h, a, b, (const T*)adj, (const T*)cnt, (const T*)etab,
      (const T*)w1, b1, (const T*)w2, b2, (T*)out, (T*)agg, (T*)mid, partial,
      S, D, D2, relu_in);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (BN) return launch_sum_partials(partial, sums, nblk, 2 * D, st);
  return 0;
}

// K1b (BN) or K4b: the three passes and the fixed-order sums. Scratch: w1t
// [D2, D], w2t [D, D2], gtc (K1b), daggc [N, D], dmidc [N, D2] (T) and the
// partials. Outputs: dh [N, D] (T); sums_rows [D2 + D] = [db1 | db2];
// sums_adj [2 D] = [da | db] (K1b); wgrad [D*D2 + D2*D + CNT_PAD*D] = [dW1
// | dW2 | detab] (f32). K4b passes null for ds, h, a, b, out, gtc,
// part_adj and sums_adj, and its dW2 multiplies g itself.
template <typename T, bool BN>
static int gine_bwd(const void* g, const float* ds, const void* h,
                    const float* a, const float* b, const void* adj,
                    const void* cnt, const void* agg, const void* mid,
                    const void* out, const void* w1, const void* w2,
                    void* w1t, void* w2t, void* gtc, void* dmidc, void* daggc,
                    float* part_rows, float* part_adj, float* part_w,
                    void* dh, float* sums_rows, float* sums_adj,
                    float* wgrad, int T_, int S, int D, int D2, int relu_in,
                    int chunks, void* stream) {
  if (T_ <= 0 || S <= 0 || S % R || D <= 0 || D2 <= 0 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const int nblk = T_ * (S / R);
  const int N = T_ * S;
  cudaStream_t st = (cudaStream_t)stream;

  int err = launch_transpose<T>(w1, w1t, D, D2, st);
  if (err) return err;
  if ((err = launch_transpose<T>(w2, w2t, D2, D, st))) return err;

  const size_t bytes_rows =
      ((size_t)R * D + (size_t)R * D2 + KC * CW + R) * sizeof(float);
  cudaError_t e = set_smem(gine_bwd_rows_kernel<T, BN>, bytes_rows);
  if (e != cudaSuccess) return (int)e;
  gine_bwd_rows_kernel<T, BN><<<nblk, NT, bytes_rows, st>>>(
      (const T*)g, ds, (const T*)adj, (const T*)mid, (const T*)out,
      (const T*)w1t, (const T*)w2t, (T*)gtc, (T*)dmidc, (T*)daggc, part_rows,
      S, D, D2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t bytes_adj = ((size_t)R * S + KC * CW + R) * sizeof(float);
  e = set_smem(gine_bwd_adj_kernel<T, BN>, bytes_adj);
  if (e != cudaSuccess) return (int)e;
  gine_bwd_adj_kernel<T, BN><<<nblk, NT, bytes_adj, st>>>(
      (const T*)daggc, (const T*)h, a, b, (const T*)adj, (T*)dh, part_adj, S,
      D, relu_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const AtB p_w1 = {agg, dmidc, D, D2, 0};
  const AtB p_w2 = {mid, BN ? (const void*)gtc : g, D2, D, D * D2};
  const AtB p_et = {cnt, daggc, CNT_PAD, D, 2 * D * D2};
  const int width = 2 * D * D2 + CNT_PAD * D;
  int rows_per_chunk = (N + chunks - 1) / chunks;
  rows_per_chunk = (rows_per_chunk + AKT - 1) / AKT * AKT;
  const int nb = chunks * (atb_tiles(p_w1) + atb_tiles(p_w2) +
                           atb_tiles(p_et));
  atb_kernel<T><<<nb, ANT, 0, st>>>(p_w1, p_w2, p_et, 3, N, rows_per_chunk,
                                    chunks, width, part_w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if ((err = launch_sum_partials(part_rows, sums_rows, nblk, D2 + D, st)))
    return err;
  if constexpr (BN) {
    err = launch_sum_partials(part_adj, sums_adj, nblk, 2 * D, st);
    if (err) return err;
  }
  return launch_sum_partials(part_w, wgrad, chunks, width, st);
}

}  // namespace fbl

extern "C" {

int fbl_strip_rows() { return fbl::R; }

#define GINE_BN_FWD(suffix, T)                                              \
  int gine_bn_fwd_##suffix(const void* h, const float* a, const float* b,   \
                           const void* adj, const void* cnt,                \
                           const void* etab, const void* w1,                \
                           const float* b1, const void* w2,                 \
                           const float* b2, void* out, void* agg, void* mid, \
                           float* partial, float* sums, int T_, int S,      \
                           int D, int D2, int relu_in, void* stream) {      \
    return fbl::gine_fwd<T, true>(h, a, b, adj, cnt, etab, w1, b1, w2, b2,  \
                                  out, agg, mid, partial, sums, T_, S, D,   \
                                  D2, relu_in, stream);                     \
  }

#define GINE_BN_BWD(suffix, T)                                              \
  int gine_bn_bwd_##suffix(                                                 \
      const void* g, const float* ds, const void* h, const float* a,        \
      const float* b, const void* adj, const void* cnt, const void* agg,    \
      const void* mid, const void* out, const void* w1, const void* w2,     \
      void* w1t, void* w2t, void* gtc, void* dmidc, void* daggc,            \
      float* part_rows, float* part_adj, float* part_w, void* dh,           \
      float* sums_rows, float* sums_adj, float* wgrad, int T_, int S,       \
      int D, int D2, int relu_in, int chunks, void* stream) {               \
    return fbl::gine_bwd<T, true>(g, ds, h, a, b, adj, cnt, agg, mid, out,  \
                                  w1, w2, w1t, w2t, gtc, dmidc, daggc,      \
                                  part_rows, part_adj, part_w, dh,          \
                                  sums_rows, sums_adj, wgrad, T_, S, D, D2, \
                                  relu_in, chunks, stream);                 \
  }

// K4f: out (and the residuals agg, mid when not null) of the unchained
// layer.
#define GINE_FWD(suffix, T)                                                 \
  int gine_fwd_##suffix(const void* h, const void* adj, const void* cnt,    \
                        const void* etab, const void* w1, const float* b1,  \
                        const void* w2, const float* b2, void* out,         \
                        void* agg, void* mid, int T_, int S, int D, int D2, \
                        void* stream) {                                     \
    return fbl::gine_fwd<T, false>(h, nullptr, nullptr, adj, cnt, etab, w1, \
                                   b1, w2, b2, out, agg, mid, nullptr,      \
                                   nullptr, T_, S, D, D2, 0, stream);       \
  }

// K4b: dh, [db1 | db2] and [dW1 | dW2 | detab] of the unchained layer.
#define GINE_BWD(suffix, T)                                                 \
  int gine_bwd_##suffix(const void* g, const void* adj, const void* cnt,    \
                        const void* agg, const void* mid, const void* w1,   \
                        const void* w2, void* w1t, void* w2t, void* dmidc,  \
                        void* daggc, float* part_rows, float* part_w,       \
                        void* dh, float* sums_rows, float* wgrad, int T_,   \
                        int S, int D, int D2, int chunks, void* stream) {   \
    return fbl::gine_bwd<T, false>(                                         \
        g, nullptr, nullptr, nullptr, nullptr, adj, cnt, agg, mid, nullptr, \
        w1, w2, w1t, w2t, nullptr, dmidc, daggc, part_rows, nullptr,        \
        part_w, dh, sums_rows, nullptr, wgrad, T_, S, D, D2, 0, chunks,     \
        stream);                                                            \
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
