// Shared pieces of the fused layer kernels (sm_90a): K1f, K1b, K3f, K3b,
// K4f, K4b, K5f and K5b.
//
// A TPU kernel of molclr_tpu/ops/fused_{layer,gcn}.py processes one whole
// 256-node tile per sequential grid step, with the tile's adjacency block
// and features resident in VMEM, and adds the masked output moments and
// the parameter gradients into resident blocks. On Hopper neither carries
// over: a tile's A (256 x 256) plus its features (256 x 300) do not fit a
// block's 227 KB of shared memory, and blocks run in parallel in no order.
// So every layer kernel runs on row blocks (the second half of this file):
//   * a block of 256 threads owns 16 rows (K1f: 32), one strip of a tile,
//     holds its left operand in shared memory and multiplies it by a right
//     operand (a weight, or the feature rows its adjacency operand reaches)
//     streamed through a ring of cp.async stages, one 128-column slice at a
//     time (rb_pass, rb_pass_rows): FP32 FMA on CUDA cores in f32 (no
//     TF32), mma.sync m16n8k16 tensor cores with f32 sums in bf16;
//   * a block multiplies only the 32-column chunks of its adjacency rows
//     that hold a nonzero (adj_live_chunks, adj_operand), and strips whose
//     rows are all dead compute no product;
//   * one adjacency pass (adj_pass_kernel, its epilogue a parameter) serves
//     K5f, K3f, K4b and K1b, and one weight pass (wgrad_kernel, up to three
//     transposed-left problems a launch, dead strips skipped) K5b, K3b, K4b
//     and K1b;
//   * each block writes its partial sums (moments, vector gradients, a
//     weight-pass chunk) to its own row of a scratch, and sum_partials adds
//     the rows in a fixed order: no atomics, so repeated runs are
//     bit-identical.
// In f32 each output is one thread's sum over k in ascending order and each
// strip's partials are summed as the first design's 16-row strip kernels
// summed them (each group of four rows, then the groups), so the f32
// results are bit-identical to that design's (a skipped term is an exact
// zero). What still holds the products back in f32: shared-memory loads
// (two wavefronts per eight FMA), padded rows of live blocks, no wgmma or
// TMA. Every value is rounded to the activation type T exactly where the
// Pallas kernels cast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace fbl {

constexpr int R = 16;        // rows of a strip (the tile layout's unit)
constexpr int CNT_PAD = 16;  // cnt columns / etab rows (ops/fused_layer.py)

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

// dst [cols, rows] = src [rows, cols]^T through a 32 x 32 shared tile
// (blocks of 32 x 8 threads).
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ src,
                                 T* __restrict__ dst, int rows, int cols) {
  __shared__ float tile[32][33];
  // member blockIdx.z of a stack of M matrices
  src += (size_t)blockIdx.z * rows * cols;
  dst += (size_t)blockIdx.z * rows * cols;
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
                                   int cols, cudaStream_t stream,
                                   int M = 1) {
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32, M), block(32, 8);
  transpose_kernel<T><<<grid, block, 0, stream>>>((const T*)src, (T*)dst,
                                                   rows, cols);
  return (int)cudaGetLastError();
}

// Ask for the largest shared-memory carveout, so that as many blocks of the
// size the kernels use as possible fit on one SM, and allow `bytes` of
// dynamic shared memory. The attributes cost microseconds of host time and the wrappers
// launch on every call, so a kernel's are set again only when a call needs
// more than this process has set on the device.
template <typename Kernel>
static inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  struct Set {
    const void* fn;
    int dev;
    size_t bytes;
  };
  static std::mutex mu;
  static Set set[32];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n && (set[i].fn != fn || set[i].dev != dev)) ++i;
  if (i < n && set[i].bytes >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (i < n)
    set[i].bytes = bytes;
  else if (n < 32)
    set[n++] = {fn, dev, bytes};
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Row-block products (every layer kernel).
//
// A block of RNT = 256 threads (8 warps) owns RB rows (16 or 32) and
// computes C[RB, ncols] = A[RB, K] @ B[K, ncols] in column passes of RCW =
// 128 columns (rb_pass). A, the left operand, lives in shared memory; B
// streams through a shared chunk of rkc<T>() = 64 rows,
// the threads staging the NEXT chunk in registers while the block
// multiplies the current one. The result of a pass lands in a shared f32
// tile Cs [RB, RCW] (stride CS), from which the caller's epilogue reads
// element by element, so that the epilogues do not depend on how the
// products are laid out on the threads.
//   * f32: full FP32 FMA on CUDA cores (no TF32). A is stored k-major
//     (A[k * RB + r]). Warp w takes all RB rows (row group lane % 8, RB / 8
//     rows each) and columns 16 w .. 16 w + 15 (column group 4 w + lane /
//     8, 4 columns): one A vector and one float4 of B feed RB / 2 FMA.
//   * bf16: tensor cores, mma.sync m16n8k16 bf16 -> f32. A is stored
//     row-major with row stride a_lda(K) (conflict-free fragment loads); B
//     chunks are stored as bf16 pairs along k (one 32-bit word per (k,
//     k + 1, c)), row stride BS2 words. Warp w takes m16 tile w % (RB / 16)
//     and RB / 8 n8 tiles. The operands are bf16 values the kernel has
//     already rounded where the Pallas kernels cast, so only the order of
//     the f32 sums differs from a scalar loop.
// K is padded to a multiple of rkc<T>() with zeros in A (the caller zeroes
// the pad) and in B (the staging masks it), so no NaN from uninitialised
// shared memory can reach a sum.

constexpr int RNT = 256;      // threads of a row-block kernel
constexpr int RCW = 128;      // output columns per pass
constexpr int CS = RCW + 4;   // row stride of the result tile Cs (floats)
constexpr int BS2 = RCW + 8;  // row stride of a bf16 pair chunk (words)
constexpr int ACW = 32;       // adjacency column chunk (skipped when zero)

// rows of one staged B chunk
template <typename T>
__host__ __device__ constexpr int rkc() { return 64; }

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride (elements) of a bf16 A operand of depth K; unused for f32.
__host__ __device__ inline int a_lda(int K) {
  return round_up(K, rkc<__nv_bfloat16>()) + 8;
}

// Bytes of an A operand [RB, K] (K padded to rkc) of element type T.
template <typename T>
__host__ __device__ inline size_t a_bytes(int rb, int K) {
  return sizeof(T) == 4 ? (size_t)round_up(K, rkc<T>()) * rb * 4
                        : (size_t)rb * a_lda(K) * 2;
}

// f32 passes that stream B through cp.async stages (rb_pass_rows) use a
// ring of one of three sizes: ring 0 is NST = 3 stages of 64 rows (two
// chunks in flight, 96 KB: a block alone on its SM), ring 1 four stages of
// 32 rows (three in flight, 64 KB: two blocks share an SM), ring 2 two
// stages of 32 rows (one in flight, 32 KB) for blocks whose operands leave
// too little shared memory for the others (the kernel's host side picks
// it).
constexpr int NST = 3, NRING = 3;

__host__ __device__ inline size_t ring_bytes(int ring) {
  return ring == 0 ? (size_t)NST * 64 * RCW * 4
                   : (size_t)(ring == 1 ? 4 : 2) * 32 * RCW * 4;
}

// bf16 passes over a row-major weight keep NSTB - 1 chunks of KCB rows in
// flight, stored [k][c] with row stride BSB elements (rb_pass_rows)
constexpr int KCB = 32, NSTB = 4, BSB = RCW + 8;

// Bytes of the scratch that rb_pass alone needs: its B chunk, aliased by
// Cs.
template <typename T>
__host__ __device__ inline size_t chunk_bytes(int rb) {
  const size_t bs = sizeof(T) == 4 ? (size_t)rkc<T>() * RCW * 4
                                   : (size_t)(rkc<T>() / 2) * BS2 * 4;
  const size_t cs = (size_t)rb * CS * 4;
  return bs > cs ? bs : cs;
}

// Bytes of the scratch a pass needs: rb_pass's B chunk or the ring of
// rb_pass_rows (`ring` for f32), aliased by Cs.
template <typename T>
__host__ __device__ inline size_t pass_bytes(int rb, int ring) {
  const size_t wring =
      sizeof(T) == 4 ? ring_bytes(ring) : (size_t)NSTB * KCB * BSB * 2;
  const size_t bs = chunk_bytes<T>(rb);
  return wring > bs ? wring : bs;
}

// The largest dynamic shared memory a block of the current device may ask
// for (227 KB on the H100); 0 if the runtime cannot say.
static inline size_t max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)v;
}

// SMs of the current device; 0 if the runtime cannot say.
static inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return v;
}

// The shared memory of a row-block kernel, in order: the live-chunk lists
// of adj_live_chunks (flags, node and width for up to maxc live chunks) and
// the node of each of their columns (knode), the node mask (32 floats), two
// operand regions of op0 and op1 bytes, and the pass scratch. Every region
// starts 16-byte aligned.
struct RbSmem {
  int nch, maxc;  // adjacency chunks per tile; live chunks a block can hold
  size_t meta, msk, op0, op1, scratch, total;
};

__host__ __device__ inline RbSmem rb_smem(int S, int maxc, size_t op0,
                                          size_t op1, size_t scratch) {
  RbSmem L;
  L.nch = (S + ACW - 1) / ACW;
  L.maxc = maxc;
  size_t off = 0;
  L.meta = off;
  off += round_up((2 * L.nch + 2 * maxc + maxc * ACW) * 4, 16);
  L.msk = off;
  off += 32 * 4;
  L.op0 = off;
  off += round_up((int)op0, 16);
  L.op1 = off;
  off += round_up((int)op1, 16);
  L.scratch = off;
  off += scratch;
  L.total = off;
  return L;
}

// A row-block launch's rows per block and f32 weight ring: the first of
// (rb0, ring0 ..), (16, ring0 ..) whose shared memory bytes(rb, ring) fits
// the device's per-block limit, so that a layer too wide for the plan's
// shape gives up pipeline depth first, then rows. The order of every f32
// sum is the same in each. rb = 0 when nothing fits. ka: the columns of a
// left operand held at a time where it streams in K-chunks (rb_stream; 0:
// held whole).
struct RbShape {
  int rb, ring;
  size_t bytes;
  int ka = 0;
};

template <typename Bytes>
static RbShape rb_shape(int rb0, int ring0, Bytes bytes) {
  const size_t cap = max_smem();
  for (int rb = rb0; rb >= R; rb -= R)
    for (int ring = ring0; ring < NRING; ++ring) {
      const size_t b = bytes(rb, ring);
      if (b <= cap) return {rb, ring, b};
    }
  return {0, 0, 0};
}

// A launch's f32 ring: the first whose block leaves room for a second on
// its SM (the 64 KB ring, then the 32 KB one), else the first that fits.
template <typename Bytes>
static RbShape rb_shape_two(Bytes bytes) {
  const size_t half = max_smem() / 2;
  for (int ring = 1; ring < NRING; ++ring) {
    const size_t b = bytes(R, ring);
    if (b <= half) return {R, ring, b};
  }
  return rb_shape(R, 1, bytes);
}

// The shape of a launch whose left operand of depth K (rows of a matrix in
// device memory) may stream through shared memory in K-chunks
// (rb_pass_streamed): pick(K), the operand held whole as it always was,
// where that fits; else pick(ka) for the widest chunk of 2,048, 1,024, 512
// or 256 columns that fits. The chunks run in ascending k and carry their
// sums in f32, so every sum keeps its order. rb = 0 when nothing fits.
template <typename Pick>
static RbShape rb_stream(int K, Pick pick) {
  RbShape s = pick(K);
  if (s.rb) return s;
  for (int ka = 2048; ka >= 256; ka /= 2) {
    if (ka >= K) continue;
    s = pick(ka);
    if (s.rb) {
      s.ka = ka;
      return s;
    }
  }
  return RbShape{0, 0, 0};
}

// A row pass of 16-row blocks whose only operand is [16, K] rows of a
// matrix in device memory (held whole, or K = ka columns of them where they
// stream): the node mask and the operand, then the pass scratch.
template <typename T>
__host__ __device__ inline RbSmem row_operand_smem(int K, int ring) {
  return rb_smem(0, 0, a_bytes<T>(R, K), 0, pass_bytes<T>(R, ring));
}

template <int RB>
__device__ __forceinline__ void a_put(float* A, int, int r, int k, float v) {
  A[k * RB + r] = v;
}
template <int RB>
__device__ __forceinline__ void a_put(__nv_bfloat16* A, int lda, int r, int k,
                                      float v) {
  A[r * lda + k] = __float2bfloat16(v);
}

// Zero A's columns k0 <= k < round_up(K, rkc) for all RB rows.
template <int RB, typename T>
__device__ void a_zero_cols(T* A, int lda, int k0, int K) {
  const int kp = round_up(K, rkc<T>());
  for (int e = threadIdx.x; e < RB * (kp - k0); e += RNT)
    a_put<RB>(A, lda, e % RB, k0 + e / RB, 0.f);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const unsigned l = __bfloat16_as_ushort(__float2bfloat16(lo));
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16(hi));
  return l | (h << 16);
}

// d[0..3] += A (16 x 16, row-major fragments a) @ B (16 x 8, b0, b1):
// one tensor-core product, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 products (rb_pass, rb_pass_rows): thread (rg = lane % 8, cg = 4 warp
// + lane / 8) holds an (RB / 8) x 4 tile, rows rg * RB/8 + i, columns 4 cg
// + j: a warp covers all RB rows and 16 columns. Per chunk row it reads
// eight A vectors and four float4 of B, each 64 or 128 contiguous bytes
// (one shared-memory wavefront apiece: the products are bound by these
// loads when two blocks share an SM), for RB / 2 FMA a thread. Each output
// is one thread's sum over k in ascending order, as a scalar loop sums it:
// the f32 results do not depend on how the rows of K are chunked (KR rows
// a chunk), which thread holds them, or which adjacency chunks are skipped
// (a skipped term is an exact 0).
template <int RB, int KR = 64>
__device__ __forceinline__ void f32_chunk(const float* Af, int k0,
                                          const float* Bs,
                                          float (&acc)[RB / 8][4]) {
  constexpr int TMR = RB / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 7, cg = 4 * warp + (lane >> 3);
#pragma unroll 8
  for (int kk = 0; kk < KR; ++kk) {
    float av[TMR];
    const float* ap = Af + (size_t)(k0 + kk) * RB + rg * TMR;
    if constexpr (TMR == 4) {
      const float4 v = *reinterpret_cast<const float4*>(ap);
      av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(ap);
      av[0] = v.x; av[1] = v.y;
    }
    const float4 b = *reinterpret_cast<const float4*>(Bs + kk * RCW + 4 * cg);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TMR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The accumulators of f32_chunk into the result tile Cs.
template <int RB>
__device__ __forceinline__ void f32_to_cs(const float (&acc)[RB / 8][4],
                                          float* Cs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 7, cg = 4 * warp + (lane >> 3);
#pragma unroll
  for (int i = 0; i < RB / 8; ++i)
    *reinterpret_cast<float4*>(Cs + (rg * RB / 8 + i) * CS + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// f32_to_cs's inverse: the accumulators of f32_chunk from Cs, so that a
// pass continues the sums a previous pass left there.
template <int RB>
__device__ __forceinline__ void f32_from_cs(float (&acc)[RB / 8][4],
                                            const float* Cs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 7, cg = 4 * warp + (lane >> 3);
#pragma unroll
  for (int i = 0; i < RB / 8; ++i) {
    const float4 v =
        *reinterpret_cast<const float4*>(Cs + (rg * RB / 8 + i) * CS + 4 * cg);
    acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
  }
}

// The bf16 products' accumulators (warp w: m16 tile w % WM, 2 WM n8 tiles
// from column (w / WM) 2 WM 8) into Cs, and back.
template <int WM>
__device__ __forceinline__ void mma_to_cs(const float (&acc)[2 * WM][4],
                                          float* Cs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % WM, nb = (warp / WM) * (2 * WM) * 8;
#pragma unroll
  for (int nt = 0; nt < 2 * WM; ++nt) {
    float* r0 = Cs + (mt * 16 + g) * CS + nb + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(r0) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(r0 + 8 * CS) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int WM>
__device__ __forceinline__ void mma_from_cs(float (&acc)[2 * WM][4],
                                            const float* Cs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % WM, nb = (warp / WM) * (2 * WM) * 8;
#pragma unroll
  for (int nt = 0; nt < 2 * WM; ++nt) {
    const float* r0 = Cs + (mt * 16 + g) * CS + nb + nt * 8 + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(r0);
    const float2 hi = *reinterpret_cast<const float2*>(r0 + 8 * CS);
    acc[nt][0] = lo.x; acc[nt][1] = lo.y; acc[nt][2] = hi.x; acc[nt][3] = hi.y;
  }
}

// The B transform of a pass that takes B as it is (see rb_pass).
struct IdentityFor {
  __device__ auto operator()(int) const {
    return [](int, float v) { return v; };
  }
};

// One column pass: Cs[r, j] = sum_k A[r, k] B[k, c0 + j] for r < RB,
// j < RCW, where B element (k, c) is xf(k, tof(load(k, c))) for k < K and
// c < ncols and 0 elsewhere, xf = xf_for(c) (made once per pass, so that
// what it reads for the column is read once). load must be valid for
// every k < K and c < ncols and free of branches: the staging clamps k and
// c into range and zeroes what lies outside, so that each thread's loads
// of a chunk issue back to back. Thread t stages column c0 + t % 128 of
// half the rows of each chunk. All threads must call it; it returns after
// a __syncthreads with Cs complete (scratch holds the chunk, then Cs).
// With CONT the sums start from the Cs that the previous pass left (the
// next K-chunk of one product, rb_pass_streamed) instead of 0.
template <typename T, int RB, bool CONT = false, typename Load,
          typename XfFor>
__device__ void rb_pass(const T* A, int lda, int K, int c0, int ncols,
                        float* scratch, Load load, XfFor xf_for) {
  static_assert(RB == 16 || RB == 32, "row block");
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KC = rkc<T>();
  constexpr int NS = KC * RCW / RNT;  // staged elements per thread
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = tid & (RCW - 1);
  const int c = c0 + col;   // the column this thread stages
  const int kh = tid >> 7;  // and which half of the chunk's rows
  // the chunk row of staged element i: f32 rows kh + 2 i; bf16 the pairs
  // (2 p, 2 p + 1), p = kh + 2 (i / 2), so that a thread packs its own
  auto row = [&](int i) {
    return F32 ? kh + 2 * i : 2 * (kh + 2 * (i >> 1)) + (i & 1);
  };
  const bool cok = c < ncols;
  const int cl = min(c, ncols - 1);
  const auto xf = xf_for(cl);
  using V = decltype(load(0, 0));
  V stage[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) stage[i] = load(min(row(i), K - 1), cl);

  constexpr int WM = RB / 16;  // bf16: m16 tiles; a warp takes 2 WM n8 tiles
  // f32: the f32_chunk tile; bf16: 2 WM n8 tiles of 4 sums
  float acc[F32 ? RB / 8 : 2 * WM][4];
  // whether any of this warp's columns lies inside ncols (a warp whose
  // columns all lie past it multiplies nothing; its sums stay 0)
  const bool wcols =
      c0 + (F32 ? 16 * warp : (warp / WM) * 2 * WM * 8) < ncols;
#pragma unroll
  for (int i = 0; i < (F32 ? RB / 8 : 2 * WM); ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if constexpr (CONT) {  // read before the loop's first __syncthreads
    if constexpr (F32)     // lets the chunk in
      f32_from_cs<RB>(acc, scratch);
    else
      mma_from_cs<WM>(acc, scratch);
  }

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk (or Cs) is consumed
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kk = row(i), k = k0 + kk;
        const float v = xf(k, tof(stage[i]));
        scratch[kk * RCW + col] = (cok && k < K) ? v : 0.f;
      }
    } else {
      unsigned* bs = reinterpret_cast<unsigned*>(scratch);
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int k = k0 + row(i);
        const float v0 = xf(k, tof(stage[i])), v1 = xf(k + 1, tof(stage[i + 1]));
        const float lo = (cok && k < K) ? v0 : 0.f;
        const float hi = (cok && k + 1 < K) ? v1 : 0.f;
        bs[(row(i) >> 1) * BS2 + col] = pack_bf16(lo, hi);
      }
    }
    __syncthreads();
    const int k1 = k0 + KC;
    if (k1 < K) {  // next chunk's loads, in flight during the products
#pragma unroll
      for (int i = 0; i < NS; ++i) stage[i] = load(min(k1 + row(i), K - 1), cl);
    }
    if constexpr (F32) {
      if (wcols)
        f32_chunk<RB>(reinterpret_cast<const float*>(A), k0, scratch, acc);
    } else {
      const __nv_bfloat16* Ab = reinterpret_cast<const __nv_bfloat16*>(A);
      const unsigned* bs = reinterpret_cast<const unsigned*>(scratch);
      const int g = lane >> 2, t = lane & 3;
      const int mt = warp % WM, nb = (warp / WM) * (2 * WM) * 8;
#pragma unroll 4
      for (int ks = 0; ks < (wcols ? KC / 16 : 0); ++ks) {
        unsigned af[4];
        const __nv_bfloat16* ap =
            Ab + (size_t)(mt * 16 + g) * lda + k0 + ks * 16 + 2 * t;
        af[0] = *reinterpret_cast<const unsigned*>(ap);
        af[1] = *reinterpret_cast<const unsigned*>(ap + 8 * lda);
        af[2] = *reinterpret_cast<const unsigned*>(ap + 8);
        af[3] = *reinterpret_cast<const unsigned*>(ap + 8 * lda + 8);
#pragma unroll
        for (int nt = 0; nt < 2 * WM; ++nt) {
          const int n = nb + nt * 8 + g;
          mma_bf16(acc[nt], af, bs[(ks * 8 + t) * BS2 + n],
                   bs[(ks * 8 + t + 4) * BS2 + n]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the chunk that Cs aliases
  if constexpr (F32)
    f32_to_cs<RB>(acc, scratch);
  else
    mma_to_cs<WM>(acc, scratch);
  __syncthreads();
}

// Asynchronous copies global -> shared of 4 and 16 bytes; the first
// `bytes` are copied and the rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One column pass as rb_pass, with B's row k at row(k) (a weight's rows, or
// the feature rows of an adjacency operand's columns) taken as it is. B
// streams from L2, and one chunk in flight leaves the block waiting on it,
// so it goes through a ring of cp.async stages: f32 keeps NS - 1 chunks of
// KR rows in flight (16-byte copies where `wide`, else 4-byte ones), bf16
// NSTB - 1 chunks of 32 rows (4-byte copies of column pairs where `wide`,
// else the rows are staged in registers by rb_pass). `wide`: every row
// starts 16-byte (f32) or 4-byte (bf16) aligned (rows_wide). row(k) is
// called for k < K only. It returns after a __syncthreads with Cs complete,
// as rb_pass does; CONT as in rb_pass.
template <typename T, int RB, int NS = NST, int KR = 64, bool CONT = false,
          typename Row>
__device__ void rb_pass_rows(const T* A, int lda, int K, int c0, int ncols,
                             float* scratch, Row row, bool wide) {
  if constexpr (sizeof(T) != 4) {
    if (!wide) {
      rb_pass<T, RB, CONT>(
          A, lda, K, c0, ncols, scratch,
          [&](int k, int c) -> T { return row(k)[c]; }, IdentityFor());
      return;
    }
    constexpr int WM = RB / 16;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int mt = warp % WM, nb = (warp / WM) * (2 * WM) * 8;
    const bool wcols = c0 + nb < ncols;  // as in rb_pass
    const int nch = (K + KCB - 1) / KCB;
    unsigned short* ring = reinterpret_cast<unsigned short*>(scratch);
    // thread t copies the column pair c0 + 2 (t % 64) (+1) of rows t / 64 +
    // 4 i; a column past ncols or a row past K is zero-filled
    const int cp = c0 + 2 * (tid & 63);
    const int nb2 = max(0, min(2, ncols - cp)) * 2;
    auto issue = [&](int ch) {
      if (ch < nch) {
        unsigned short* slot = ring + (size_t)(ch % NSTB) * KCB * BSB;
#pragma unroll
        for (int i = 0; i < KCB / 4; ++i) {
          const int kk = (tid >> 6) + 4 * i, k = ch * KCB + kk;
          cp_async4(reinterpret_cast<float*>(slot + kk * BSB + 2 * (tid & 63)),
                    reinterpret_cast<const float*>(row(min(k, K - 1)) +
                                                   (nb2 ? cp : 0)),
                    k < K ? nb2 : 0);
        }
      }
      cp_async_commit();
    };
    float acc[2 * WM][4];
#pragma unroll
    for (int i = 0; i < 2 * WM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if constexpr (CONT) mma_from_cs<WM>(acc, scratch);
    const __nv_bfloat16* Ab = reinterpret_cast<const __nv_bfloat16*>(A);
    __syncthreads();  // the ring (or Cs) is no longer read
#pragma unroll
    for (int st = 0; st < NSTB - 1; ++st) issue(st);
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<NSTB - 2>();
      __syncthreads();
      issue(ch + NSTB - 1);
      const unsigned short* bs = ring + (size_t)(ch % NSTB) * KCB * BSB;
      if (!wcols) continue;
#pragma unroll
      for (int ks = 0; ks < KCB / 16; ++ks) {
        unsigned af[4];
        const __nv_bfloat16* ap =
            Ab + (size_t)(mt * 16 + g) * lda + ch * KCB + ks * 16 + 2 * t;
        af[0] = *reinterpret_cast<const unsigned*>(ap);
        af[1] = *reinterpret_cast<const unsigned*>(ap + 8 * lda);
        af[2] = *reinterpret_cast<const unsigned*>(ap + 8);
        af[3] = *reinterpret_cast<const unsigned*>(ap + 8 * lda + 8);
        const unsigned short* b = bs + (ks * 16 + 2 * t) * BSB;
#pragma unroll
        for (int nt = 0; nt < 2 * WM; ++nt) {
          const int n = nb + nt * 8 + g;
          const unsigned b0 = b[n] | ((unsigned)b[BSB + n] << 16);
          const unsigned b1 =
              b[8 * BSB + n] | ((unsigned)b[9 * BSB + n] << 16);
          mma_bf16(acc[nt], af, b0, b1);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    mma_to_cs<WM>(acc, scratch);
    __syncthreads();
  } else {
    static_assert(NS >= 2 && KR % 8 == 0, "ring");
    constexpr int KC = KR;
    const int tid = threadIdx.x;
    const bool wcols = c0 + 16 * (tid >> 5) < ncols;  // as in rb_pass
    const int nch = (K + KC - 1) / KC;
    // 16-byte copies where `wide`: thread t copies columns 4 (t % 32) .. +
    // 3 of rows t / 32 + 8 i; else 4-byte copies, thread t column t % 128
    // of rows t / 128 + 2 i. Columns past ncols and rows past K are
    // zero-filled.
    const int c4 = c0 + 4 * (tid & 31), c1 = c0 + (tid & (RCW - 1));
    const int n4 = max(0, min(4, ncols - c4)) * 4;
    auto issue = [&](int ch) {  // chunk ch into ring slot ch % NS
      if (ch < nch) {
        float* slot = scratch + (size_t)(ch % NS) * KC * RCW;
        if (wide) {
#pragma unroll
          for (int i = 0; i < KC / 8; ++i) {
            const int kk = (tid >> 5) + 8 * i, k = ch * KC + kk;
            cp_async16(slot + kk * RCW + 4 * (tid & 31),
                       row(min(k, K - 1)) + (n4 ? c4 : 0), k < K ? n4 : 0);
          }
        } else {
#pragma unroll
          for (int i = 0; i < KC / 2; ++i) {
            const int kk = (tid >> 7) + 2 * i, k = ch * KC + kk;
            cp_async4(slot + kk * RCW + (tid & (RCW - 1)),
                      row(min(k, K - 1)) + min(c1, ncols - 1),
                      (c1 < ncols && k < K) ? 4 : 0);
          }
        }
      }
      cp_async_commit();
    };
    float acc[RB / 8][4];
#pragma unroll
    for (int i = 0; i < RB / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if constexpr (CONT) f32_from_cs<RB>(acc, scratch);
    __syncthreads();  // the ring (or Cs) is no longer read
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) issue(s);
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<NS - 2>();  // this thread's copies of chunk ch landed
      __syncthreads();          // everyone's; chunk ch - 1 is consumed
      issue(ch + NS - 1);
      if (wcols)
        f32_chunk<RB, KC>(reinterpret_cast<const float*>(A), ch * KC,
                          scratch + (size_t)(ch % NS) * KC * RCW, acc);
    }
    cp_async_wait<0>();
    __syncthreads();
    f32_to_cs<RB>(acc, scratch);
    __syncthreads();
  }
}

// rb_pass_rows with the f32 ring `ring` (ring_bytes; bf16 has one).
template <typename T, int RB, bool CONT = false, typename Row>
__device__ void rb_pass_rr(int ring, const T* A, int lda, int K, int c0,
                           int ncols, float* scratch, Row row, bool wide) {
  if constexpr (sizeof(T) == 4) {
    if (ring == 1) {
      rb_pass_rows<T, RB, 4, 32, CONT>(A, lda, K, c0, ncols, scratch, row,
                                       wide);
      return;
    }
    if (ring == 2) {
      rb_pass_rows<T, RB, 2, 32, CONT>(A, lda, K, c0, ncols, scratch, row,
                                       wide);
      return;
    }
  }
  rb_pass_rows<T, RB, NST, 64, CONT>(A, lda, K, c0, ncols, scratch, row,
                                     wide);
}

// Whether rows that start at p (and q) plus multiples of ld elements take
// rb_pass_rows' wide copies: 16-byte aligned in f32, 4-byte in bf16.
template <typename T>
__device__ inline bool rows_wide(int ld, const T* p, const T* q = nullptr) {
  const size_t al = sizeof(T) == 4 ? 16 : 4;
  const size_t bits =
      reinterpret_cast<size_t>(p) | reinterpret_cast<size_t>(q);
  return (ld * sizeof(T)) % al == 0 && bits % al == 0;
}

// One column pass over a row-major [K, ncols] weight W of row stride ldw
// with the f32 ring `ring`.
template <typename T, int RB>
__device__ void rb_pass_wr(int ring, const T* A, int lda, int K, int c0,
                           int ncols, float* scratch, const T* W, int ldw) {
  rb_pass_rr<T, RB>(
      ring, A, lda, K, c0, ncols, scratch,
      [=](int k) { return W + (size_t)k * ldw; }, rows_wide(ldw, W));
}

// Copy a pass's final values, left in Cs by the caller's epilogue, into
// columns c0 .. min(c0 + RCW, ncols) - 1 of an A operand. f32 operands are
// k-major, so the threads run along the rows there (a bank-conflict-free
// store); bf16 operands are row-major and the threads run along the
// columns. All threads must call it, after a __syncthreads that follows
// the epilogue's writes to Cs.
template <int RB, typename T>
__device__ void cs_to_a(T* A, int lda, int c0, int ncols, const float* Cs) {
  for (int e = threadIdx.x; e < RB * RCW; e += RNT) {
    const int r = sizeof(T) == 4 ? e % RB : e / RCW;
    const int j = sizeof(T) == 4 ? e / RB : e % RCW;
    if (c0 + j < ncols) a_put<RB>(A, lda, r, c0 + j, Cs[r * CS + j]);
  }
}

// The live 32-column chunks of the adjacency rows row0 .. row0 + nrows - 1
// (nrows <= 32, each 16-row strip inside one tile): a chunk (tile, j) is
// live when a row of the block that belongs to that tile has a nonzero in
// tile columns 32 j .. 32 j + 31. Fills node[i] (the first node of live
// chunk i, in tile order then column order) and width[i] (32, or less at the
// end of a tile whose size is not a multiple of 32) and returns their count;
// flags is shared scratch of 2 * ceil(S / 32) ints. msk[r] is the node mask
// diag(A) > 0 of row r (0 beyond nrows). All threads must call it; it ends
// with a __syncthreads.
template <typename T>
__device__ int adj_live_chunks(const T* adj, size_t row0, int nrows, int S,
                               int* flags, int* node, int* width, float* msk) {
  const int nch = (S + ACW - 1) / ACW;
  const int tile0 = (int)(row0 / S);
  for (int i = threadIdx.x; i < 2 * nch; i += RNT) flags[i] = 0;
  if (threadIdx.x < 32) {
    const int r = threadIdx.x;
    float m = 0.f;
    if (r < nrows) {
      const size_t row = row0 + r;
      m = ld(adj, row * S + row % S) > 0.f ? 1.f : 0.f;
    }
    msk[r] = m;
  }
  __syncthreads();
  // 16-byte loads: S is a multiple of 16, so a vector never spans chunks
  constexpr int VE = 16 / sizeof(T);
  const int per_row = S / VE;
  for (int e = threadIdx.x; e < nrows * per_row; e += RNT) {
    const int r = e / per_row, v = e % per_row;
    const size_t row = row0 + r;
    const uint4 q = *reinterpret_cast<const uint4*>(adj + row * S + v * VE);
    if ((q.x | q.y | q.z | q.w) & (sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu))
      flags[((int)(row / S) - tile0) * nch + v * VE / ACW] = 1;
  }
  __syncthreads();
  int n = 0;
  const int tiles = (int)((row0 + nrows - 1) / S) - tile0 + 1;
  for (int tt = 0; tt < tiles; ++tt)
    for (int j = 0; j < nch; ++j)
      if (flags[tt * nch + j]) {
        if (threadIdx.x == 0) {
          node[n] = (tile0 + tt) * S + j * ACW;
          width[n] = min(ACW, S - j * ACW);
        }
        ++n;
      }
  __syncthreads();  // node and width are written; flags may be reused
  return n;
}

// Build a row block's adjacency operand from adj_live_chunks' list: xa
// (row stride lda) = [A live chunks | cnt rows] for rows row0 .. row0 +
// nrows - 1, columns in list order, zero in rows past nrows and in the
// columns up to round_up(K, rkc), where K = nlive * 32 (+ CNT_PAD with
// cnt; cnt null: the A chunks alone). knode[k] is the node whose features
// column k < nlive * 32 multiplies (clamped into its chunk: A is 0 past a
// chunk's width, and in a row of another tile than the chunk's). All
// threads must call it; a __syncthreads must follow before xa is read
// (rb_pass begins with one).
template <int RB, typename T>
__device__ void adj_operand(const T* adj, const T* cnt, size_t row0,
                            int nrows, int S, int nlive, const int* node,
                            const int* width, int* knode, T* xa, int lda) {
  const int KL = nlive * ACW, K = KL + (cnt ? CNT_PAD : 0);
  a_zero_cols<RB>(xa, lda, 0, K);
  for (int k = threadIdx.x; k < KL; k += RNT)
    knode[k] = node[k / ACW] + min(k % ACW, width[k / ACW] - 1);
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * K; e += RNT) {
    const int r = e / K, k = e % K;
    const size_t row = row0 + r;
    float v;
    if (k < KL) {
      const int li = k / ACW, kk = k % ACW, col = node[li] + kk;
      v = (kk < width[li] && (size_t)col / S == row / S)
              ? ld(adj, row * S + col % S) : 0.f;
    } else {
      v = ld(cnt, row * CNT_PAD + (k - KL));
    }
    a_put<RB>(xa, lda, r, k, v);
  }
}

// Whether any of the cnt rows row0 .. row0 + nrows - 1 holds a nonzero,
// decided by value (normalize_gcn weights the counts). `live` is a shared
// int. All threads must call it; it begins and ends with a __syncthreads.
template <typename T>
__device__ bool cnt_rows_live(const T* cnt, size_t row0, int nrows,
                              int* live) {
  if (threadIdx.x == 0) *live = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * CNT_PAD; e += RNT)
    if (ld(cnt, row0 * CNT_PAD + e) != 0.f) *live = 1;
  __syncthreads();
  return *live != 0;
}

// The transform of rows_to_a that takes the rows as they are.
struct AsIs {
  __device__ float operator()(int, float v) const { return v; }
};

// Load columns k0 .. k0 + K - 1 of rows row0 .. row0 + nrows - 1 of a
// row-major matrix of row stride lds into an A operand (row stride lda),
// element (r, k) as xf(k0 + k, value), zero in rows past nrows and in the
// columns up to round_up(K, rkc). f32 operands are k-major, so the threads
// run along the rows there (conflict-free stores; a row's loads meet in
// L1). All threads must call it; a __syncthreads must follow before A is
// read (rb_pass and rb_pass_rows begin with one).
template <int RB, typename T, typename Xf = AsIs>
__device__ void rows_to_a_cols(T* A, int lda, const T* src, int lds, int k0,
                               size_t row0, int nrows, int K, Xf xf = Xf()) {
  const int kp = round_up(K, rkc<T>());
  for (int e = threadIdx.x; e < RB * kp; e += RNT) {
    const int r = sizeof(T) == 4 ? e % RB : e / kp;
    const int k = sizeof(T) == 4 ? e / RB : e % kp;
    a_put<RB>(A, lda, r, k,
              r < nrows && k < K
                  ? xf(k0 + k, ld(src, (row0 + r) * lds + k0 + k)) : 0.f);
  }
}

// rows_to_a_cols of whole rows of a row-major [*, K] matrix.
template <int RB, typename T, typename Xf = AsIs>
__device__ void rows_to_a(T* A, int lda, const T* src, size_t row0,
                          int nrows, int K, Xf xf = Xf()) {
  rows_to_a_cols<RB>(A, lda, src, K, 0, row0, nrows, K, xf);
}

// One column pass Cs = src[rows row0 .., :K] @ W[:K, c0 .. c0 + RCW) with
// the f32 ring `ring`, W row-major of row stride ldw, its left operand the
// RB rows of the row-major [*, K] matrix src in device memory (rows past
// nrows zero; element (r, k) taken as xf(k, value), rows_to_a's transform):
// held in A whole (not STREAM: one rows_to_a, one rb_pass_wr,
// as every launch that fits does), or (STREAM) ka columns at a time
// (rb_stream), the chunks in ascending k, Cs zeroed first and each pass
// continuing the sums in Cs in f32. So each f32 output is one thread's sum
// over k in ascending order from 0 either way, and in bf16 the tensor-core
// products run in the same order (ka a multiple of 64). A holds
// a_bytes<T>(RB, STREAM ? ka : K). All threads must call it, before
// anything else uses scratch; it returns after a __syncthreads with Cs
// complete.
template <typename T, int RB, bool STREAM, typename Xf = AsIs>
__device__ void rb_pass_streamed(int ring, int ka, T* A, const T* src,
                                 size_t row0, int nrows, int K, int c0,
                                 int ncols, float* scratch, const T* W,
                                 int ldw, Xf xf = Xf()) {
  if constexpr (!STREAM) {
    const int lda = a_lda(K);
    rows_to_a<RB>(A, lda, src, row0, nrows, K, xf);
    rb_pass_wr<T, RB>(ring, A, lda, K, c0, ncols, scratch, W, ldw);
  } else {
    for (int e = threadIdx.x; e < RB * CS; e += RNT) scratch[e] = 0.f;
    __syncthreads();
    const bool wide = rows_wide(ldw, W);
    for (int k0 = 0; k0 < K; k0 += ka) {
      // (the previous pass ended in a __syncthreads after its last read of
      // A)
      const int kc = min(ka, K - k0), lda = a_lda(kc);
      rows_to_a_cols<RB>(A, lda, src, K, k0, row0, nrows, kc, xf);
      rb_pass_rr<T, RB, true>(
          ring, A, lda, kc, c0, ncols, scratch,
          [=](int k) { return W + (size_t)(k0 + k) * ldw; }, wide);
    }
  }
}

// The row-block adjacency pass: K5f's second pass, K3f's (with the counts)
// and K4b's and K1b's. One block of RNT threads per (16-row strip,
// RCW-column slice) computes Cs = [A_strip | cnt rows] @ [X ; etab] for its
// slice over the strip's live 32-column chunks only, X's rows (the nodes of
// those chunks) and etab's gathered through the weight ring; cnt null: Cs =
// A_strip @ X. A strip whose A rows (and cnt rows) are all zero has Cs = 0
// with no load and no product. Then all threads call epi(row0, c0, Cs,
// msk), which writes the slice from Cs[r * CS + j] (rows r < R, columns c0
// + j < D; msk[r] the node mask diag(A) > 0 of row r) and may overwrite Cs.
// In f32 each output is one thread's sum over the live columns, then the
// counts, in ascending order, so a skipped chunk (exact zeros) leaves the
// dense strip's bits. With a members epilogue (Epi::kMembers), member
// blockIdx.z of a stack reads x + z xs (the adjacency, the counts and etab
// are shared) and the epilogue offsets what it writes; the one-layer
// epilogues compile without either.
template <typename T>
__host__ __device__ inline RbSmem adj_pass_smem(int S, int ring, bool cnt) {
  const int nch = (S + ACW - 1) / ACW;
  return rb_smem(S, nch, a_bytes<T>(R, nch * ACW + (cnt ? CNT_PAD : 0)), 0,
                 pass_bytes<T>(R, ring));
}

template <typename T, typename Epi>
__global__ void __launch_bounds__(RNT, 2)
adj_pass_kernel(const T* __restrict__ x, const T* __restrict__ adj,
                const T* __restrict__ cnt, const T* __restrict__ etab,
                Epi epi, int S, int D, int ring, size_t xs) {
  extern __shared__ float smem_f[];  // 16-byte aligned
  if constexpr (Epi::kMembers) x += blockIdx.z * xs;
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  __shared__ int cnt_live;
  const RbSmem L = adj_pass_smem<T>(S, ring, cnt != nullptr);
  int* flags = reinterpret_cast<int*>(smem + L.meta);
  int* node = flags + 2 * L.nch;
  int* width = node + L.maxc;
  int* knode = width + L.maxc;
  float* msk = reinterpret_cast<float*>(smem + L.msk);
  T* ext = reinterpret_cast<T*>(smem + L.op0);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  const size_t row0 = (size_t)blockIdx.x * R;
  const int cb = blockIdx.y * RCW;  // this block's slice
  const bool clive = cnt && cnt_rows_live(cnt, row0, R, &cnt_live);
  const int nlive = adj_live_chunks(adj, row0, R, S, flags, node, width,
                                    msk);
  if (nlive == 0 && !clive) {
    for (int e = threadIdx.x; e < R * RCW; e += RNT)
      scratch[(e / RCW) * CS + e % RCW] = 0.f;
    __syncthreads();
  } else {
    const int KL = nlive * ACW, K = KL + (cnt ? CNT_PAD : 0);
    const int lda = a_lda(K);
    adj_operand<R, T>(adj, cnt, row0, R, S, nlive, node, width, knode, ext,
                      lda);
    rb_pass_rr<T, R>(
        ring, ext, lda, K, cb, D, scratch,
        [&](int k) {
          return k < KL ? x + (size_t)knode[k] * D
                        : etab + (size_t)(k - KL) * D;
        },
        rows_wide(D, x, etab));
  }
  epi(row0, cb, scratch, msk);
}

// adj_pass_kernel's epilogue out = rnd(Cs) (K5f, K4b's dh; K5b's strip
// pass stores dx with it).
template <typename T>
struct AdjStore {
  static constexpr bool kMembers = false;
  T* out;
  int D;
  __device__ void operator()(size_t row0, int c0, float* Cs,
                             const float* msk) const {
    for (int e = threadIdx.x; e < R * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) st(out, (row0 + r) * D + c, Cs[r * CS + j]);
    }
  }
};

// AdjStore for member blockIdx.z of a stack of outputs ms elements apart
// (the member-axis launches of K5f, K4b and K5b).
template <typename T>
struct AdjStoreMembers {
  static constexpr bool kMembers = true;
  T* out;
  int D;
  size_t ms;
  __device__ void operator()(size_t row0, int c0, float* Cs,
                             const float* msk) const {
    AdjStore<T>{out + blockIdx.z * ms, D}(row0, c0, Cs, msk);
  }
};

// The BatchNorm prologue's adjoint as an epilogue (K1b's adjacency pass,
// K3b's strip pass): dx = Cs (f32, not rounded), dpre = dx [h a + b > 0 if
// relu_in], dh = rnd(dpre a), the recomputed prologue output xc =
// rnd(relu?(h a + b)) when xc is not null (K3b's weight pass multiplies
// it), and the strip's [da | db] partials (sum dpre h, sum dpre) at row
// row0 / 16 of partial [N / 16, 2 D], each group of four rows summed, then
// the groups in order (the first design's order).
template <typename T>
struct BnAdjoint {
  static constexpr bool kMembers = false;
  const T* h;
  const float* a;
  const float* b;
  T* dh;
  T* xc;
  float* partial;
  int D, relu_in;
  __device__ void operator()(size_t row0, int c0, float* Cs,
                             const float*) const {
    const int tid = threadIdx.x;
    for (int e = tid; e < R * RCW; e += RNT) {
      const int r = e / RCW, j = e % RCW, c = c0 + j;
      if (c < D) {
        const size_t i = (row0 + r) * D + c;
        const float hf = ld(h, i), dx = Cs[r * CS + j];
        const float pre = prologue(hf, a[c], b[c], 0);
        const float dpre = (!relu_in || pre > 0.f) ? dx : 0.f;
        st(dh, i, __fmul_rn(dpre, a[c]));
        if (xc) st(xc, i, relu_in ? fmaxf(pre, 0.f) : pre);
        Cs[r * CS + j] = dpre;
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
          const float dpre = Cs[r * CS + tid];
          const float hf = ld(h, (row0 + r) * D + c);
          s0 += dpre * hf;
          s1 += dpre;
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

// The adjacency pass over N rows at the 64 KB f32 ring (the 32 KB one
// where shared memory does not fit), for M members whose x are N x D apart
// (the epilogue's output likewise); cnt and etab null but for K3f.
template <typename T, typename Epi>
static int launch_adj_pass(const void* x, const void* adj, const Epi& epi,
                           int N, int S, int D, cudaStream_t st,
                           const void* cnt = nullptr,
                           const void* etab = nullptr, int M = 1) {
  const RbShape sh = rb_shape(R, 1, [&](int, int rg) {
    return adj_pass_smem<T>(S, rg, cnt != nullptr).total;
  });
  if (!sh.rb) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(adj_pass_kernel<T, Epi>, sh.bytes);
  if (e != cudaSuccess) return (int)e;
  adj_pass_kernel<T, Epi>
      <<<dim3(N / R, (D + RCW - 1) / RCW, M), RNT, sh.bytes, st>>>(
          (const T*)x, (const T*)adj, (const T*)cnt, (const T*)etab, epi, S,
          D, sh.ring, (size_t)N * D);
  return (int)cudaGetLastError();
}

// Weight-gradient products of the backward passes (K5b, K3b, K4b, K1b):
// C[m, c] = sum_r X[r, m] Y[r, c] over the rows of one chunk, for one TR x
// 64 output tile per block (TR = 64, or 32 where the caller wants more
// blocks than 64-row tiles give), written to partial[chunk, off + m * C +
// c]; the caller adds the chunks in chunk order (sum_partials). Up to three
// problems share one launch (block order: problem, chunk, tile). Each
// 16-row step is one strip of the row space: a strip whose live flag is 0
// (the pass that wrote Y recorded that every problem's rows there multiply
// only zeros) is skipped, and a chunk with no live strip writes zeros
// without loading anything. The block lists its live strips in parallel (a
// ballot over the chunk's flags), then streams their X and Y rows through a
// ring of WST shared-memory stages of one strip each (WST - 1 strips in
// flight) with cp.async (16-byte copies for f32 rows of whole float4s, else
// 4-byte ones; bf16 rows of odd width are loaded directly), one
// __syncthreads a step. f32 runs FP32 FMA ((TR / 16) x 4 per thread, vector
// shared loads), each output one thread's sum over the chunk's rows in
// ascending order, as the first design's weight pass summed it; bf16 runs
// mma.sync m16n8k16 with X^T as the A operand (warp w: m16 tile w % (TR /
// 16), TR / 16 n8 tiles of column group w / (TR / 16)), its fragments
// paired from the staged rows. Member blockIdx.y of a stack of M problems
// reads X + y xs, Y + y ys (a stride of 0 shares a matrix), its strips'
// flags at y N / 16 and writes its partials y chunks width further.
constexpr int WT = 64;    // output tile columns (and rows at most)
constexpr int WK = 16;    // rows per strip
constexpr int WNT = 256;  // threads
constexpr int WST = 4;    // ring stages
constexpr int WMAX_ROWS = 1024;  // most rows of one chunk


struct WProb {
  const void* x;  // [N, m]
  const void* y;  // [N, c]
  int m, c;       // output shape
  int off;        // offset of this problem's output in a partial row
  size_t xs = 0, ys = 0;  // elements between members' x, y
};

__host__ __device__ inline int wgrad_tiles(const WProb& p, int tr) {
  return ((p.m + tr - 1) / tr) * ((p.c + WT - 1) / WT);
}

// One step's copies of wgrad_kernel: rows r0 .. r0 + WK - 1 of src (row
// stride and width `cols`), columns col0 .. col0 + W - 1, into dst (row
// pitch `pitch` elements), EW elements a copy: cp.async of EW * sizeof(T)
// bytes when ASYNC, else loads and stores. Rows at or past r_hi and
// columns past `cols` are zero-filled.
template <int W, int EW, bool ASYNC, typename T>
__device__ __forceinline__ void wgrad_copy(T* dst, const T* src, int cols,
                                           int col0, int r0, int r_hi,
                                           int pitch) {
  constexpr int WPR = W / EW;  // copies per row
  for (int e = threadIdx.x; e < WK * WPR; e += WNT) {
    const int kk = e / WPR, cc = (e % WPR) * EW;
    const int r = r0 + kk, c = col0 + cc;
    const int nv = r < r_hi ? max(0, min(EW, cols - c)) : 0;
    if constexpr (ASYNC) {
      float* d = reinterpret_cast<float*>(dst + kk * pitch + cc);
      const float* s =
          reinterpret_cast<const float*>(nv ? src + (size_t)r * cols + c : src);
      if constexpr (EW * sizeof(T) == 16)
        cp_async16(d, s, nv * (int)sizeof(T));
      else
        cp_async4(d, s, nv * (int)sizeof(T));
    } else {
#pragma unroll
      for (int h = 0; h < EW; ++h)
        st(dst, kk * pitch + cc + h,
           h < nv ? ld(src, (size_t)r * cols + c + h) : 0.f);
    }
  }
}

// (held to 64 registers, so that four blocks share an SM: faster at the
// pretraining shape than the 80 registers it takes unbounded)
template <typename T, int TR, bool MEM>
__global__ void __launch_bounds__(WNT, 4)
wgrad_kernel(WProb p0, WProb p1, WProb p2, int nprob,
             const int* __restrict__ strip_live, int N, int rows_per_chunk,
             int chunks, float* __restrict__ partial, int width) {
  static_assert(TR == 64 || TR == 32, "tile rows");
  static_assert(WMAX_ROWS / WK <= 64, "a chunk's strips fit two ballots");
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int RM = TR / 16;  // f32: rows per thread; bf16: m16 tiles
  // a stage: X rows [WK, XP] then Y rows [WK, YP] (elements of T)
  constexpr int XP = F32 ? TR : TR + 8, YP = F32 ? WT : WT + 8;
  constexpr int STAGE = WK * (XP + YP) * (int)sizeof(T) / 4;  // words
  __shared__ __align__(16) float ring[WST * STAGE];
  __shared__ int steps[WMAX_ROWS / WK];
  __shared__ int wcnt[2];
  int blk = blockIdx.x, q = 0;
  for (; q < nprob - 1; ++q) {
    const int nb = chunks * wgrad_tiles(q == 0 ? p0 : p1, TR);
    if (blk < nb) break;
    blk -= nb;
  }
  const WProb p = q == 0 ? p0 : q == 1 ? p1 : p2;
  const int M = p.m, C = p.c;
  const T* X = (const T*)p.x;
  const T* Y = (const T*)p.y;
  if constexpr (MEM) {  // member blockIdx.y
    X += blockIdx.y * p.xs;
    Y += blockIdx.y * p.ys;
    strip_live += blockIdx.y * (N / WK);
    partial += (size_t)blockIdx.y * chunks * width;
  }
  const int tiles_c = (C + WT - 1) / WT;
  const int tiles = ((M + TR - 1) / TR) * tiles_c;
  const int chunk = blk / tiles, tl = blk % tiles;
  const int m0 = (tl / tiles_c) * TR, c0 = (tl % tiles_c) * WT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r_lo = chunk * rows_per_chunk;
  const int r_hi = min(N, r_lo + rows_per_chunk);

  // the chunk's live strips, in order: thread i < 64 reads strip i's flag
  const int nst = (r_hi - r_lo + WK - 1) / WK;
  bool lv = false;
  unsigned bal = 0;
  if (tid < 64) {
    lv = tid < nst && strip_live[r_lo / WK + tid];
    bal = __ballot_sync(0xffffffffu, lv);
    if (lane == 0) wcnt[tid >> 5] = __popc(bal);
  }
  __syncthreads();
  if (lv)
    steps[(tid >= 32 ? wcnt[0] : 0) + __popc(bal & ((1u << lane) - 1))] =
        r_lo + tid * WK;
  const int ns = wcnt[0] + wcnt[1];
  __syncthreads();
  float* prow = partial + (size_t)chunk * width + p.off;

  // copies of EW elements (16 bytes for f32 rows of whole float4s, else 4:
  // one f32 element or a bf16 column pair; bf16 rows of odd width are
  // loaded directly); rows past the chunk, columns past the matrix zero
  const bool vec = (((M | C) & 3) == 0 &&
                    ((reinterpret_cast<size_t>(X) |
                      reinterpret_cast<size_t>(Y)) & 15) == 0);
  const bool wide = (((M | C) & 1) == 0 &&
                     ((reinterpret_cast<size_t>(X) |
                       reinterpret_cast<size_t>(Y)) & 3) == 0);
  auto issue = [&](int s) {
    if (s < ns) {
      T* xd = reinterpret_cast<T*>(ring + (s % WST) * STAGE);
      T* yd = xd + WK * XP;
      const int r0 = steps[s];
      if constexpr (F32) {
        if (vec) {
          wgrad_copy<TR, 4, true>(xd, X, M, m0, r0, r_hi, XP);
          wgrad_copy<WT, 4, true>(yd, Y, C, c0, r0, r_hi, YP);
        } else {
          wgrad_copy<TR, 1, true>(xd, X, M, m0, r0, r_hi, XP);
          wgrad_copy<WT, 1, true>(yd, Y, C, c0, r0, r_hi, YP);
        }
      } else if (wide) {
        wgrad_copy<TR, 2, true>(xd, X, M, m0, r0, r_hi, XP);
        wgrad_copy<WT, 2, true>(yd, Y, C, c0, r0, r_hi, YP);
      } else {
        wgrad_copy<TR, 2, false>(xd, X, M, m0, r0, r_hi, XP);
        wgrad_copy<WT, 2, false>(yd, Y, C, c0, r0, r_hi, YP);
      }
    }
    cp_async_commit();
  };

  float acc[TR / 4];
#pragma unroll
  for (int i = 0; i < TR / 4; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < WST - 1; ++s) issue(s);
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<WST - 2>();  // this thread's copies of step s landed
    __syncthreads();           // everyone's; step s - 1 is consumed
    issue(s + WST - 1);
    const float* slot = ring + (s % WST) * STAGE;
    if constexpr (F32) {
      const float* xs = slot;
      const float* ys = slot + WK * XP;
      const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
      for (int kk = 0; kk < WK; ++kk) {
        float av[RM];
        if constexpr (RM == 4) {
          const float4 a =
              *reinterpret_cast<const float4*>(xs + kk * TR + 4 * ty);
          av[0] = a.x; av[1] = a.y; av[2] = a.z; av[3] = a.w;
        } else {
          const float2 a =
              *reinterpret_cast<const float2*>(xs + kk * TR + 2 * ty);
          av[0] = a.x; av[1] = a.y;
        }
        const float4 b =
            *reinterpret_cast<const float4*>(ys + kk * WT + 4 * tx);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
      }
    } else {
      const unsigned short* xh = reinterpret_cast<const unsigned short*>(slot);
      const unsigned short* yh = xh + WK * XP;
      // the bf16 pair (row k, row k + 1) at column c, k in the low half
      auto pair = [](const unsigned short* m, int pitch, int k, int c) {
        return (unsigned)m[k * pitch + c] |
               ((unsigned)m[(k + 1) * pitch + c] << 16);
      };
      const int warp = tid >> 5, g = lane >> 2, t = lane & 3;
      const int mb = (warp % RM) * 16, ng = warp / RM;
      const unsigned a[4] = {pair(xh, XP, 2 * t, mb + g),
                             pair(xh, XP, 2 * t, mb + g + 8),
                             pair(xh, XP, 2 * t + 8, mb + g),
                             pair(xh, XP, 2 * t + 8, mb + g + 8)};
#pragma unroll
      for (int nt = 0; nt < RM; ++nt) {
        const int nb = ng * RM * 8 + nt * 8 + g;
        mma_bf16(&acc[nt * 4], a, pair(yh, YP, 2 * t, nb),
                 pair(yh, YP, 2 * t + 8, nb));
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (F32) {
    const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + RM * ty + i, c = c0 + 4 * tx + j;
        if (m < M && c < C) prow[(size_t)m * C + c] = acc[i * 4 + j];
      }
  } else {
    const int warp = tid >> 5, g = lane >> 2, t = lane & 3;
    const int mb = (warp % RM) * 16, ng = warp / RM;
#pragma unroll
    for (int nt = 0; nt < RM; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mb + g + (e >> 1) * 8;
        const int c = c0 + ng * RM * 8 + nt * 8 + 2 * t + (e & 1);
        if (m < M && c < C) prow[(size_t)m * C + c] = acc[nt * 4 + e];
      }
  }
}

// The weight pass over nprob (1 to 3) problems: `chunks` row chunks of
// rows_per_chunk rows, which the caller chooses (ops/fused_gcn.py
// dw_chunks, ops/fused_layer.py weight_pass_shape) and this only
// checks (a multiple of 16, at most WMAX_ROWS, covering the N rows once),
// times each problem's tiles of tile_rows (64 or 32) x 64, times M members.
template <typename T>
static int launch_wgrad(const WProb* p, int nprob, const int* strip_live,
                        int N, int rows_per_chunk, int chunks, int tile_rows,
                        float* partial, int width, cudaStream_t st,
                        int M = 1) {
  if (nprob < 1 || nprob > 3 || rows_per_chunk <= 0 ||
      rows_per_chunk % WK || rows_per_chunk > WMAX_ROWS ||
      (N + rows_per_chunk - 1) / rows_per_chunk != chunks ||
      (tile_rows != WT && tile_rows != WT / 2))
    return (int)cudaErrorInvalidValue;
  int nb = 0;
  for (int q = 0; q < nprob; ++q) nb += chunks * wgrad_tiles(p[q], tile_rows);
  const WProb p1 = nprob > 1 ? p[1] : p[0], p2 = nprob > 2 ? p[2] : p[0];
  auto kernel = M > 1 ? (tile_rows == WT ? wgrad_kernel<T, WT, true>
                                         : wgrad_kernel<T, WT / 2, true>)
                      : (tile_rows == WT ? wgrad_kernel<T, WT, false>
                                         : wgrad_kernel<T, WT / 2, false>);
  kernel<<<dim3(nb, M), WNT, 0, st>>>(p[0], p1, p2, nprob, strip_live, N,
                                      rows_per_chunk, chunks, partial,
                                      width);
  return (int)cudaGetLastError();
}

// sums[i] = sum over blocks, in block order, of partial[blk, i]; i < width;
// for member blockIdx.y of a stack, partial and sums nblk x width and width
// further.
// sum_partials: one thread per column, its loads 16 rows at a time.
// sum_partials_tiled: a block of SUM_NT threads per 32 columns, whose warps
// stage up to SUM_ROWS rows at a time in shared memory (many loads in
// flight on each of many SMs), and whose first warp adds them in row
// order. Both add in block order, one thread per column, so they agree bit
// for bit. The tiled kernel is taken for many rows of few columns (at least
// SUM_TILE_MIN rows, at most SUM_TILE_MAX_WIDTH columns: the strip
// partials of a batch of four tiles or more), where the column kernel
// runs on a few SMs only; it is slower elsewhere, the weight passes'
// chunk partials included (runs/port_sum_partials.py on an H100).
constexpr int SUM_NT = 256, SUM_ROWS = 256, SUM_TILE_MIN = 64,
              SUM_TILE_MAX_WIDTH = 4096;

template <bool MEM>
__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ sums, int nblk, int width) {
  if constexpr (MEM) {
    partial += (size_t)blockIdx.y * nblk * width;
    sums += (size_t)blockIdx.y * width;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float t = 0.f;
  int blk = 0;
  for (; blk + 16 <= nblk; blk += 16) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = partial[(size_t)(blk + j) * width + i];
#pragma unroll
    for (int j = 0; j < 16; ++j) t += v[j];
  }
  for (; blk < nblk; ++blk) t += partial[(size_t)blk * width + i];
  sums[i] = t;
}

template <bool MEM>
__global__ void __launch_bounds__(SUM_NT)
sum_partials_tiled(const float* __restrict__ partial, float* __restrict__ sums,
                   int nblk, int width) {
  __shared__ float tile[SUM_ROWS][33];
  if constexpr (MEM) {
    partial += (size_t)blockIdx.y * nblk * width;
    sums += (size_t)blockIdx.y * width;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float t = 0.f;
  for (int b0 = 0; b0 < nblk; b0 += SUM_ROWS) {
    const int nb = min(SUM_ROWS, nblk - b0);
    __syncthreads();  // the previous rows are added
#pragma unroll 8
    for (int r = warp; r < nb; r += SUM_NT / 32)
      tile[r][lane] = i < width ? partial[(size_t)(b0 + r) * width + i] : 0.f;
    __syncthreads();
    if (warp == 0) {
      int r = 0;
      for (; r + 16 <= nb; r += 16) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = tile[r + j][lane];
#pragma unroll
        for (int j = 0; j < 16; ++j) t += v[j];
      }
      for (; r < nb; ++r) t += tile[r][lane];
    }
  }
  if (warp == 0 && i < width) sums[i] = t;
}

static inline int launch_sum_partials(const float* partial, float* sums,
                                      int nblk, int width,
                                      cudaStream_t stream, int M = 1) {
  if (nblk >= SUM_TILE_MIN && width <= SUM_TILE_MAX_WIDTH)
    (M > 1 ? sum_partials_tiled<true> : sum_partials_tiled<false>)
        <<<dim3((width + 31) / 32, M), SUM_NT, 0, stream>>>(partial, sums,
                                                            nblk, width);
  else
    (M > 1 ? sum_partials<true> : sum_partials<false>)
        <<<dim3((width + 255) / 256, M), 256, 0, stream>>>(partial, sums,
                                                           nblk, width);
  return (int)cudaGetLastError();
}

}  // namespace fbl

// The layout constants that the Python side plans with
// (ops/fused_layer.py LAYOUT, checked against this at the library's first
// use): entry i of [strip rows, adjacency chunk, weight-pass tile edge,
// weight-pass rows per step, most rows of a weight-pass chunk, columns of a
// row-block pass]; -1 past the end. Each library includes this header
// once.
extern "C" int fbl_layout(int i) {
  const int v[] = {fbl::R, fbl::ACW, fbl::WT, fbl::WK, fbl::WMAX_ROWS,
                   fbl::RCW};
  return i >= 0 && i < (int)(sizeof(v) / sizeof(v[0])) ? v[i] : -1;
}
