"""K1b and K4b against their first design, on the card, in one process.

    python3 runs/port_gine_bwd.py --parent DIR   (repository root, card)

DIR holds the first design's kernel sources (molclr_tpu_torch/csrc/ of the
commit before the redesign, e.g. `git archive <commit>
molclr_tpu_torch/csrc | tar -x -C DIR`, DIR under a git-ignored directory
such as build/). They are built with nvcc into DIR/build/ and called
through ctypes with the first design's entry points:
  gine_bn_bwd_<t>(g, ds, h, a, b, adj, cnt, agg, mid, out, w1, w2, w1t, w2t,
                  gtc, dmidc, daggc, part_rows, part_adj, part_w, dh,
                  sums_rows, sums_adj, wgrad, T, S, D, D2, relu_in, chunks,
                  stream)                                  (K1b)
  gine_bwd_<t>(g, adj, cnt, agg, mid, w1, w2, w1t, w2t, dmidc, daggc,
               part_rows, part_w, dh, sums_rows, wgrad, T, S, D, D2, chunks,
               stream)                                     (K4b)
  gcn_fwd_<t>, gcn_bwd_<t>, gcn_bn_bwd_<t>                 (K5f, K5b, K3b)

On chip_smoke.py's full-width layer inputs (D = 300, D2 = 600, tile 256),
the cotangent on the real rows, in f32 and bf16:
  * K1b (relu_in, as layers 2-5 run it) and K4b at T = 4 (the fine-tuning
    batch), 22 (the pretraining batch) and 44 (the pretraining batch
    twice, as concat_views packs its two views): every output
    of the two designs compared bit for bit, and timed: CUDA-event ms,
    device us per pass (torch.profiler over 20 calls) and host us per
    call, in the order first, new, new, first;
  * K5f and K5b at T = 4 and K3b at T = 22 (their adjacency pass and
    weight pass now share code with K4b and K1b), outputs compared bit for
    bit.
Every f32 output must be bit-identical to the first design's (the redesign
keeps the order of every f32 sum), and `cuobjdump -sass` of the built
library must show HMMA (tensor-core) instructions in every bf16 kernel of
K1b and K4b (the dmid, dagg, adjacency and weight launches) and none in the
f32 ones; the script exits 1 otherwise. Prints one JSON line per case and
writes them all to --out."""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.data.graphs import concat_views  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402
from molclr_tpu_torch.ops import fused_gcn as FG  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402

F32 = dict(dtype=torch.float32)


def build_first_design(parent: Path) -> dict:
    """The first design's libraries, built in parallel."""
    src = parent / "molclr_tpu_torch" / "csrc"
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("fused_gine_bn", "fused_gcn_bn"):
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def entry(lib, fn, n_ptr, n_int):
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def ptrs(*ts):
    return [t.data_ptr() for t in ts]


def concat_batch():
    """The pretraining batch and itself as one batch, as concat_views packs
    its two views (T = 44)."""
    batch = cs.pretrain_batch()[0].to("cpu")
    return concat_views(batch, batch)


def first_k1b(lib, sfx, stream):
    fn = entry(lib, f"gine_bn_bwd_{sfx}", 24, 6)

    def run(g, dsums, h, a, b, adj, cnt, agg, mid, out, w1, w2, relu_in):
        t, s, _ = adj.shape
        n, d = g.shape
        d2 = w1.shape[1]
        nblk, chunks = n // 16, -(-n // FL.BWD_CHUNK_ROWS)
        width = 2 * d * d2 + FL.CNT_PAD * d
        f32 = dict(F32, device=g.device)
        gtc, daggc, dh = (torch.empty_like(g) for _ in range(3))
        dmidc = g.new_empty(n, d2)
        w1t, w2t = w1.new_empty(d2, d), w2.new_empty(d, d2)
        part_rows = torch.empty(nblk, d2 + d, **f32)
        part_adj = torch.empty(nblk, 2 * d, **f32)
        part_w = torch.empty(chunks, width, **f32)
        sums_rows = torch.empty(d2 + d, **f32)
        sums_adj = torch.empty(2 * d, **f32)
        wgrad = torch.empty(width, **f32)
        _build.check(fn(*ptrs(g, dsums, h, a, b, adj, cnt, agg, mid, out, w1,
                              w2, w1t, w2t, gtc, dmidc, daggc, part_rows,
                              part_adj, part_w, dh, sums_rows, sums_adj,
                              wgrad),
                        t, s, d, d2, int(relu_in), chunks, stream),
                     "first K1b")
        dw1, dw2, detab = wgrad.split([d * d2, d2 * d, FL.CNT_PAD * d])
        return (dh, sums_adj[:d], sums_adj[d:], dw1.view(d, d2),
                sums_rows[:d2], dw2.view(d2, d), sums_rows[d2:],
                detab.view(FL.CNT_PAD, d))
    return run


def first_k4b(lib, sfx, stream):
    fn = entry(lib, f"gine_bwd_{sfx}", 16, 5)

    def run(g, adj, cnt, agg, mid, w1, w2):
        t, s, _ = adj.shape
        n, d = g.shape
        d2 = w1.shape[1]
        nblk, chunks = n // 16, -(-n // FL.BWD_CHUNK_ROWS)
        width = 2 * d * d2 + FL.CNT_PAD * d
        f32 = dict(F32, device=g.device)
        daggc, dh = torch.empty_like(g), torch.empty_like(g)
        dmidc = g.new_empty(n, d2)
        w1t, w2t = w1.new_empty(d2, d), w2.new_empty(d, d2)
        part_rows = torch.empty(nblk, d2 + d, **f32)
        part_w = torch.empty(chunks, width, **f32)
        sums_rows = torch.empty(d2 + d, **f32)
        wgrad = torch.empty(width, **f32)
        _build.check(fn(*ptrs(g, adj, cnt, agg, mid, w1, w2, w1t, w2t, dmidc,
                              daggc, part_rows, part_w, dh, sums_rows, wgrad),
                        t, s, d, d2, chunks, stream), "first K4b")
        dw1, dw2, detab = wgrad.split([d * d2, d2 * d, FL.CNT_PAD * d])
        return (dh, dw1.view(d, d2), sums_rows[:d2], dw2.view(d2, d),
                sums_rows[d2:], detab.view(FL.CNT_PAD, d))
    return run


def first_gcn(lib, sfx, stream):
    """The first design's K5f, K5b and K3b."""
    fwd = entry(lib, f"gcn_fwd_{sfx}", 5, 3)
    bwd = entry(lib, f"gcn_bwd_{sfx}", 10, 5)
    bn_bwd = entry(lib, f"gcn_bn_bwd_{sfx}", 20, 5)

    def k5f(x, adj, w):
        t, s, _ = adj.shape
        xw, out = torch.empty_like(x), torch.empty_like(x)
        _build.check(fwd(*ptrs(x, adj, w, xw, out), t, s, x.shape[1],
                         stream), "first K5f")
        return (out,)

    def k5b(g, x, adj, w):
        t, s, _ = adj.shape
        n, d = g.shape
        chunks, rows = FG.dw_chunks(n, d, FL.sm_count(g.device))
        wt, dxw, dx = w.new_empty(d, d), torch.empty_like(g), \
            torch.empty_like(g)
        live = torch.empty(n // 16, dtype=torch.int32, device=g.device)
        part_w = torch.empty(chunks, d * d, dtype=torch.float32,
                             device=g.device)
        dw = torch.empty(d, d, dtype=torch.float32, device=g.device)
        _build.check(bwd(*ptrs(g, x, adj, w, wt, dxw, dx, live, part_w, dw),
                         t, s, d, chunks, rows, stream), "first K5b")
        return dx, dw

    def k3b(g, dsums, x, a, b, adj, cnt, out, w, relu_in):
        t, s, _ = adj.shape
        n, d = g.shape
        nblk, chunks = n // 16, -(-n // FL.BWD_CHUNK_ROWS)
        width = d * d + FL.CNT_PAD * d
        f32 = dict(F32, device=g.device)
        wt = w.new_empty(d, d)
        gtc, dxw, xc, dx = (torch.empty_like(g) for _ in range(4))
        part_gt = torch.empty(nblk, d, **f32)
        part_adj = torch.empty(nblk, 2 * d, **f32)
        part_w = torch.empty(chunks, width, **f32)
        dbias = torch.empty(d, **f32)
        sums_adj = torch.empty(2 * d, **f32)
        wgrad = torch.empty(width, **f32)
        _build.check(bn_bwd(*ptrs(g, dsums, x, a, b, adj, cnt, out, w, wt,
                                  gtc, dxw, xc, part_gt, part_adj, part_w, dx,
                                  dbias, sums_adj, wgrad),
                            t, s, d, int(relu_in), chunks, stream),
                     "first K3b")
        dw, detab = wgrad.split([d * d, FL.CNT_PAD * d])
        return (dx, sums_adj[:d], sums_adj[d:], dw.view(d, d), dbias,
                detab.view(FL.CNT_PAD, d))
    return k5f, k5b, k3b


def hmma_counts(lib: Path) -> dict:
    """HMMA (tensor-core) instructions in each K1b / K4b kernel of a built
    library, from `cuobjdump -sass`."""
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(k in name for k in (
                "gine_bwd", "adj_pass_kernel", "wgrad_kernel")) else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def compare(names, a, b):
    same = {k: torch.equal(u, v) for k, u, v in zip(names, a, b)}
    diff = {k: (u.float() - v.float()).abs().max().item()
            for k, u, v in zip(names, a, b)}
    return same, diff


def timing(calls) -> dict:
    """ms (first, new, new, first), device us by pass and host us."""
    res = {k: dict(ms=[]) for k in calls}
    for k in ("first", "new", "new", "first"):
        res[k]["ms"].append(cs.time_ms(calls[k]))
    for k, fn in calls.items():
        res[k]["device_us"] = cs.pass_profile(fn)
        res[k]["device_us_total"] = sum(res[k]["device_us"].values())
        res[k]["host_us"] = cs.host_us(fn)
    return res


K1B_OUT = ("dh", "da", "db", "dw1", "db1", "dw2", "db2", "detab")
K4B_OUT = ("dh", "dw1", "db1", "dw2", "db2", "detab")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_gine_bwd.jsonl"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    first = build_first_design(args.parent)
    _build.build_all()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_out, ok = [], True

    def emit(row):
        nonlocal ok
        row["card"] = card
        if row["dtype"] == "f32" and not all(row["bit_identical"].values()):
            ok = False
        rows_out.append(row)
        print(json.dumps(row), flush=True)

    batches = {4: cs.finetune_batch(), 22: cs.pretrain_batch()[0],
               44: concat_batch()}
    for t, batch in batches.items():
        batch = batch.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            sfx = "f32" if dt == torch.float32 else "bf16"
            gen = torch.Generator().manual_seed(cs.SEED + 3)
            x, pg, pc = cs.layer_inputs(batch, dt, gen)
            mask = FL.adj_diag_mask(x["adj"])
            n, d = x["h"].shape
            g = ((0.1 * torch.randn(n, d, generator=gen)).to(dev)
                 * mask).to(dt)
            dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
            out, _, agg, mid = FL.fused_gine_bn_layer_fwd(
                *cs.gine_args(x, pg), True, residuals=True)
            bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"],
                     agg, mid, out, pg["w1"], pg["w2"], True)
            old = first_k1b(first["fused_gine_bn"], sfx, stream)
            calls = {"first": lambda: old(*bargs),
                     "new": lambda: FL.fused_gine_bn_layer_bwd(*bargs)}
            same, diff = compare(K1B_OUT, calls["first"](), calls["new"]())
            emit(dict(kernel="k1b", tiles=int(x["adj"].shape[0]), dtype=sfx,
                      bit_identical=same, max_abs_diff=diff,
                      timing=timing(calls)))

            h = (x["h"].float() * mask).to(dt)
            fargs = (h, x["adj"], x["cnt"], pg["etab"], pg["w1"], pg["b1"],
                     pg["w2"], pg["b2"])
            _, agg, mid = FL.fused_gine_layer_fwd(*fargs, residuals=True)
            uargs = (g, x["adj"], x["cnt"], agg, mid, pg["w1"], pg["w2"])
            old4 = first_k4b(first["fused_gine_bn"], sfx, stream)
            calls = {"first": lambda: old4(*uargs),
                     "new": lambda: FL.fused_gine_layer_bwd(*uargs)}
            same, diff = compare(K4B_OUT, calls["first"](), calls["new"]())
            emit(dict(kernel="k4b", tiles=int(x["adj"].shape[0]), dtype=sfx,
                      bit_identical=same, max_abs_diff=diff,
                      timing=timing(calls)))

            k5f, k5b, k3b = first_gcn(first["fused_gcn_bn"], sfx, stream)
            if t == 4:
                same, diff = compare(("out",), k5f(h, x["adj"], pc["w"]),
                                     (FG.fused_gcn_layer_fwd(
                                         h, x["adj"], pc["w"]),))
                emit(dict(kernel="k5f", tiles=t, dtype=sfx,
                          bit_identical=same, max_abs_diff=diff))
                gargs = (g, h, x["adj"], pc["w"])
                same, diff = compare(("dx", "dw"), k5b(*gargs),
                                     FG.fused_gcn_layer_bwd(*gargs))
                emit(dict(kernel="k5b", tiles=t, dtype=sfx,
                          bit_identical=same, max_abs_diff=diff))
            if t == 22:
                cargs = cs.gcn_args(x, pc)
                gout, _ = FG.fused_gcn_bn_layer(*cargs, True)
                kargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"],
                         x["cnt"], gout, pc["w"], True)
                same, diff = compare(
                    ("dx", "da", "db", "dw", "dbias", "detab"), k3b(*kargs),
                    FG.fused_gcn_bn_layer_bwd(*kargs))
                emit(dict(kernel="k3b", tiles=t, dtype=sfx,
                          bit_identical=same, max_abs_diff=diff))
    # tensor cores in every bf16 kernel of K1b / K4b, none in the f32 ones
    hmma = hmma_counts(_build._lib_path(_build.CSRC / "fused_gine_bwd.cu"))
    bf16 = {k: v for k, v in hmma.items() if "bfloat16" in k}
    f32 = {k: v for k, v in hmma.items() if "bfloat16" not in k}
    sass_ok = all(bf16.values()) and not any(f32.values()) and bf16 and f32
    row = dict(kernel="sass", card=card, hmma=hmma, ok=bool(sass_ok))
    rows_out.append(row)
    print(json.dumps(row), flush=True)
    ok = ok and bool(sass_ok)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows_out))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
