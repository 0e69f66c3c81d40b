"""Where a block of K4f's and K5f's launches spends its time, on the card.

    python3 runs/port_unchained_trace.py      (repository root, on a card)

Copies molclr_tpu_torch/csrc/ into build/trace/csrc/ and inserts
%globaltimer stamps (thread 0 of each block) into K4f's mid and out
kernels and K5f's xw pass: the block's start, the end of its adjacency
scan and operand build, its agg and mid passes, its end, and inside each
ring pass the time spent waiting on chunks and computing them (the rest
of a pass is its start and its epilogue). Builds that copy with nvcc
(the flags of ops/_build.py), runs each kernel once at the fine-tuning
shape (chip_smoke.py phase 8's batch and inputs, T = 4, D = 300) in f32 and bf16 after three warm-up calls, and prints per
launch the median and the largest of each phase over its live blocks
(microseconds). The timestamps add a few instructions per chunk, so the
spans run a little longer than uninstrumented launches. The stamps are
inserted by text replacement: the script raises if the sources no longer
match."""

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402

OUT = ROOT / "build" / "trace"
SLOT = 24  # stamps per block
OUT_BASE = 2048  # K4f's out launch writes the slots from this block on


def rep(s, old, new):
    if old not in s:
        raise RuntimeError(f"source changed, cannot place a stamp: {old!r}")
    return s.replace(old, new)


def instrument():
    """The instrumented copy of csrc/. Slot of a block (SLOT int64): [0]
    start [1] adjacency scan done [2] operand built [3] agg done [4] end
    [5] the weight pass done [6] dead [7] SM; [8, 9, 11] and [16, 17, 19]
    the agg passes' and the weight pass's ns waiting on chunks and
    computing them, and their chunk count."""
    src, dst = ROOT / "molclr_tpu_torch" / "csrc", OUT / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    c = (dst / "fused_bn_common.cuh").read_text()
    c = rep(c, "namespace fbl {\n", """namespace fbl {
__device__ long long* g_trace;
__device__ __forceinline__ long long gtime() {
  long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t;
}
__device__ __forceinline__ long long smid() {
  unsigned s; asm volatile("mov.u32 %0, %%smid;" : "=r"(s)); return s;
}
__device__ __forceinline__ long long* tslot(int base) {
  return g_trace && threadIdx.x == 0
             ? g_trace + 24 * (base + blockIdx.x + gridDim.x * blockIdx.y)
             : nullptr;
}
""")
    c = rep(c, "                             float* scratch, Row row, bool wide) {",
            "                             float* scratch, Row row, bool wide,\n"
            "                             long long* ts = nullptr) {\n"
            "  long long tw = 0, tc = 0, ta = 0, tb = 0;")
    for wait in ("      cp_async_wait<NSTB - 2>();\n      __syncthreads();\n",
                 "      cp_async_wait<NS - 2>();  // this thread's copies of "
                 "chunk ch landed\n      __syncthreads();          // "
                 "everyone's; chunk ch - 1 is consumed\n"):
        c = rep(c, wait, "      ta = gtime();\n" + wait
                + "      tb = gtime(); tw += tb - ta;\n")
    c = rep(c, "          mma_bf16(acc[nt], af, b0, b1);\n        }\n      }\n"
            "    }\n    cp_async_wait<0>();",
            "          mma_bf16(acc[nt], af, b0, b1);\n        }\n      }\n"
            "      tc += gtime() - tb;\n    }\n    cp_async_wait<0>();")
    c = rep(c, "scratch + (size_t)(ch % NS) * KC * RCW, acc);\n    }\n"
            "    cp_async_wait<0>();",
            "scratch + (size_t)(ch % NS) * KC * RCW, acc);\n"
            "      tc += gtime() - tb;\n    }\n    cp_async_wait<0>();")
    c = rep(c, "    cp_async_wait<0>();\n    __syncthreads();\n",
            "    cp_async_wait<0>();\n    __syncthreads();\n"
            "    if (ts) { ts[0] += tw; ts[1] += tc; ts[3] += nch; }\n")
    c = rep(c, "                           int ncols, float* scratch, Row row, "
            "bool wide) {",
            "                           int ncols, float* scratch, Row row, "
            "bool wide,\n                           long long* ts = nullptr) {")
    c = rep(c, "scratch, row, wide);", "scratch, row, wide, ts);")
    c = rep(c, "float* scratch, const T* W, int ldw) {\n  rb_pass_rr<T, RB>(",
            "float* scratch, const T* W, int ldw,\n"
            "                           long long* ts = nullptr) {\n"
            "  rb_pass_rr<T, RB>(")
    c = rep(c, "rows_wide(ldw, W));\n}", "rows_wide(ldw, W), ts);\n}")
    c += ('\nextern "C" int fbl_set_trace(long long* p) {\n'
          "  return (int)cudaMemcpyToSymbol(fbl::g_trace, &p, sizeof(p));\n}\n")
    (dst / "fused_bn_common.cuh").write_text(c)

    g = (dst / "fused_gine_bn.cu").read_text()
    g = rep(g, "namespace fbl {\n", f"namespace fbl {{\nconstexpr int OUT_BASE = "
            f"{OUT_BASE};\n")
    g = rep(g, "  T* const agg_w = blockIdx.y == 0 ? agg_out : nullptr;\n",
            "  T* const agg_w = blockIdx.y == 0 ? agg_out : nullptr;\n"
            "  long long* ts = tslot(0);\n"
            "  if (ts) { ts[0] = gtime(); ts[7] = smid(); }\n")
    g = rep(g, "  if (nlive == 0 && !cnt_live) {\n    if (agg_w)",
            "  if (ts) ts[1] = gtime();\n"
            "  if (nlive == 0 && !cnt_live) {\n    if (ts) ts[6] = 1;\n"
            "    if (agg_w)")
    g = rep(g, "rnd<T>(fmaxf(0.f + b1[c], 0.f)));\n    }\n    return;\n",
            "rnd<T>(fmaxf(0.f + b1[c], 0.f)));\n    }\n"
            "    if (ts) ts[4] = gtime();\n    return;\n")
    g = rep(g, "  // [h ; etab] streams through the ring",
            "  __syncthreads();\n  if (ts) ts[2] = gtime();\n"
            "  // [h ; etab] streams through the ring")
    g = rep(g, "    rb_pass_rr<T, R>(ring, xa, lda1, K1, c0, D, scratch, brow, "
            "wide);\n",
            "    rb_pass_rr<T, R>(ring, xa, lda1, K1, c0, D, scratch, brow, "
            "wide,\n                     ts ? ts + 8 : nullptr);\n")
    g = rep(g, "    cs_to_a<R>(ga, lda2, c0, D, scratch);\n  }\n\n"
            "  rb_pass_wr<T, R>(ring, ga, lda2, D, cb, D2, scratch, w1, D2);\n",
            "    cs_to_a<R>(ga, lda2, c0, D, scratch);\n  }\n"
            "  if (ts) ts[3] = gtime();\n\n"
            "  rb_pass_wr<T, R>(ring, ga, lda2, D, cb, D2, scratch, w1, D2,\n"
            "                    ts ? ts + 16 : nullptr);\n"
            "  if (ts) ts[5] = gtime();\n")
    g = rep(g, "rnd<T>(fmaxf(scratch[r * CS + j] + b1[c], 0.f)));\n  }\n}\n",
            "rnd<T>(fmaxf(scratch[r * CS + j] + b1[c], 0.f)));\n  }\n"
            "  if (ts) ts[4] = gtime();\n}\n")
    g = rep(g, "  const int lda = a_lda(D2);\n",
            "  const int lda = a_lda(D2);\n  long long* ts = tslot(OUT_BASE);\n"
            "  if (ts) { ts[0] = ts[1] = gtime(); ts[7] = smid(); }\n")
    g = rep(g, "  rb_pass_wr<T, R>(ring, ma, lda, D2, cb, D, scratch, w2, D);\n",
            "  __syncthreads();\n  if (ts) ts[2] = ts[3] = gtime();\n"
            "  rb_pass_wr<T, R>(ring, ma, lda, D2, cb, D, scratch, w2, D,\n"
            "                    ts ? ts + 16 : nullptr);\n"
            "  if (ts) ts[5] = gtime();\n")
    g = rep(g, "rnd<T>(scratch[r * CS + j] + b2[c]));\n  }\n}\n",
            "rnd<T>(scratch[r * CS + j] + b2[c]));\n  }\n"
            "  if (ts) ts[4] = gtime();\n}\n")
    (dst / "fused_gine_bn.cu").write_text(g)

    k = (dst / "fused_gcn_bn.cu").read_text()
    k = rep(k, "  const int cb = blockIdx.y * RCW;  // this block's pass of xw\n",
            "  const int cb = blockIdx.y * RCW;  // this block's pass of xw\n"
            "  long long* ts = tslot(0);\n"
            "  if (ts) { ts[0] = gtime(); ts[7] = smid(); }\n")
    k = rep(k, "  if (adj_live_chunks(adj, row0, R, S, flags, node, width, msk) "
            "== 0) {\n",
            "  const int nl = adj_live_chunks(adj, row0, R, S, flags, node, "
            "width, msk);\n  if (ts) ts[1] = gtime();\n  if (nl == 0) {\n"
            "    if (ts) { ts[6] = 1; ts[4] = gtime(); }\n")
    k = rep(k, "  rb_pass_wr<T, R>(ring, xa, lda, D, cb, D, scratch, w, D);\n",
            "  __syncthreads();\n  if (ts) ts[2] = ts[3] = gtime();\n"
            "  rb_pass_wr<T, R>(ring, xa, lda, D, cb, D, scratch, w, D,\n"
            "                   ts ? ts + 16 : nullptr);\n"
            "  if (ts) ts[5] = gtime();\n")
    k = rep(k, "    if (c < D) st(xw, (row0 + r) * D + c, scratch[r * CS + j]);"
            "\n  }\n}\n",
            "    if (c < D) st(xw, (row0 + r) * D + c, scratch[r * CS + j]);"
            "\n  }\n  if (ts) ts[4] = gtime();\n}\n")
    (dst / "fused_gcn_bn.cu").write_text(k)


def build():
    (OUT / "lib").mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("fused_gine_bn", "fused_gcn_bn"):
        lib = OUT / "lib" / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(OUT / "csrc" / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def summary(trace, base, nblk):
    """Median and largest phase times (us) over the live blocks of the
    launch whose slots start at block `base`."""
    tr = trace.view(-1, SLOT)[base:base + nblk].cpu().tolist()
    live = [r for r in tr if r[6] == 0]
    t0 = min(r[0] for r in tr)

    def st(f):
        v = [f(r) / 1e3 for r in live]
        return [round(statistics.median(v), 2), round(max(v), 2)]

    return dict(
        blocks=nblk, live=len(live), span_us=round(
            (max(r[4] for r in tr) - t0) / 1e3, 2),
        block_us=st(lambda r: r[4] - r[0]), scan_us=st(lambda r: r[1] - r[0]),
        operand_us=st(lambda r: r[2] - r[1]),
        agg_us=st(lambda r: r[3] - r[2]), agg_wait_us=st(lambda r: r[8]),
        agg_compute_us=st(lambda r: r[9]),
        pass_us=st(lambda r: r[5] - r[3]), pass_wait_us=st(lambda r: r[16]),
        pass_compute_us=st(lambda r: r[17]), chunks=[
            statistics.median(r[11] for r in live),
            statistics.median(r[19] for r in live)],
        most_live_per_sm=max(
            sum(1 for r in live if r[7] == sm) for sm in {r[7] for r in tr}))


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    instrument()
    libs = build()
    trace = torch.zeros(SLOT * 4096, dtype=torch.int64, device=dev)
    for lib in libs.values():
        f = lib.fbl_set_trace
        f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int
        if f(trace.data_ptr()):
            raise RuntimeError("fbl_set_trace failed")
    stream = torch.cuda.current_stream(dev).cuda_stream
    batch = cs.finetune_batch().to(dev)
    for dt in (torch.float32, torch.bfloat16):
        sfx = "f32" if dt == torch.float32 else "bf16"
        x, pg, pc = cs.layer_inputs(batch, dt, torch.Generator().manual_seed(
            cs.SEED + 4))
        h = (x["h"].float() * FL.adj_diag_mask(x["adj"])).to(dt)
        adj, cnt = x["adj"], x["cnt"]
        t, s, _ = adj.shape
        n, d = h.shape
        d2 = pg["w1"].shape[1]
        grids = FL.unchained_fwd_plan(t, s, d, d2)
        gine = getattr(libs["fused_gine_bn"], f"gine_fwd_{sfx}")
        gine.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        gcn = getattr(libs["fused_gcn_bn"], f"gcn_fwd_{sfx}")
        gcn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
        out, agg, mid = torch.empty_like(h), torch.empty_like(h), \
            h.new_empty(n, d2)
        xw, o2 = torch.empty_like(h), torch.empty_like(h)
        ptrs = [v.data_ptr() for v in (h, adj, cnt, pg["etab"], pg["w1"],
                                       pg["b1"], pg["w2"], pg["b2"], out, agg,
                                       mid)]

        def k4f():
            return gine(*ptrs, t, s, d, d2, stream)

        def k5f():
            return gcn(h.data_ptr(), adj.data_ptr(), pc["w"].data_ptr(),
                       xw.data_ptr(), o2.data_ptr(), t, s, d, stream)

        report = dict(card=card, dtype=sfx, grids=grids)
        for name, fn, launches in (
                ("k4f", k4f, (("k4f_mid", 0), ("k4f_out", OUT_BASE))),
                ("k5f", k5f, (("k5f_xw", 0),))):
            for _ in range(3):
                if fn():
                    raise RuntimeError(f"{name} failed")
            torch.cuda.synchronize()
            trace.zero_()
            if fn():
                raise RuntimeError(f"{name} failed")
            torch.cuda.synchronize()
            for launch, base in launches:
                nb, sl = grids[launch]
                report[launch] = summary(trace, base, nb * sl)
        print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
