"""K3f and K3b against their first design, on the card, in one process.

    python3 runs/port_gcn_bn.py --parent DIR   (repository root, card)

DIR holds the first design's kernel sources (molclr_tpu_torch/csrc/ of the
commit before the redesign, e.g. `git archive <commit>
molclr_tpu_torch/csrc | tar -x -C DIR`, DIR under a git-ignored directory
such as build/). They are built with nvcc into DIR/build/ and called
through ctypes with the first design's entry points:
  gcn_bn_fwd_<t>(x, a, b, adj, cnt, etab, w, bias, xw, out, partial, sums,
                 T, S, D, relu_in, stream)                       (K3f)
  gcn_bn_bwd_<t>(g, ds, x, a, b, adj, cnt, out, w, wt, gtc, dxw, xc,
                 part_gt, part_adj, part_w, dx, dbias, sums_adj, wgrad,
                 T, S, D, relu_in, chunks, stream)               (K3b)
The kernels that share code with K3 and kept their entry points (K5f, K5b,
K1f, K1b, K4f, K4b) are run from DIR's libraries through the port's own
wrappers.

On chip_smoke.py's full-width layer inputs (D = 300, tile 256) at T = 18
(the embed batch), 22 (the pretraining batch) and 47 (the pretraining batch
with hydrogens, as GCN mix packs it), relu_in off and on, with the plain
adjacency and counts and with the normalize_gcn weights, in f32 and bf16:
  * every output of K3f (out, sums) and K3b (dx, da, db, dW, dbias, detab)
    of the two designs compared bit for bit (the int32 view of each
    tensor); K3b takes K3f's output and a cotangent on every row;
  * K5f and K5b at T = 4 (the fine-tuning batch), K1f, K1b, K4f and K4b
    at T = 22, compared likewise;
  * at each T, relu_in on and the plain adjacency, both designs of K3f
    and K3b timed in the order first, new, new, first: CUDA-event ms,
    device us per pass (torch.profiler over 20 calls) and host us per
    call.
Every f32 output must be bit-identical to the first design's, and
`cuobjdump -sass` of the built library must show HMMA (tensor-core)
instructions in every bf16 product kernel of K3f and K3b (the xw,
adjacency, strip and weight passes) and none in the f32 ones; the script
exits 1 otherwise. Prints one JSON line per case and writes them all to
--out. --no-timing skips the timing (a check run)."""

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.models.layers import edge_counts  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402
from molclr_tpu_torch.ops import fused_gcn as FG  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402
from molclr_tpu_torch.ops.tile_dense import (  # noqa: E402
    gcn_normalization,
    normalize_tile_adjacency,
)

SOURCES = ("fused_gcn_bn", "fused_gine_bn")
K3F_OUT = ("out", "sums")
K3B_OUT = ("dx", "da", "db", "dw", "dbias", "detab")


def build_first_design(parent: Path) -> dict:
    """The first design's libraries, built in parallel."""
    src = parent / "molclr_tpu_torch" / "csrc"
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
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


def first_k3(lib, sfx, stream):
    """The first design's K3f and K3b."""
    fwd = entry(lib, f"gcn_bn_fwd_{sfx}", 12, 4)
    bwd = entry(lib, f"gcn_bn_bwd_{sfx}", 20, 5)
    f32 = dict(dtype=torch.float32)

    def k3f(x, a, b, adj, cnt, etab, w, bias, relu_in):
        t, s, _ = adj.shape
        n, d = x.shape
        xw, out = torch.empty_like(x), torch.empty_like(x)
        partial = torch.empty(n // 16, 2, d, device=x.device, **f32)
        sums = torch.empty(2, d, device=x.device, **f32)
        _build.check(fwd(*ptrs(x, a, b, adj, cnt, etab, w, bias, xw, out,
                               partial, sums), t, s, d, int(relu_in),
                         stream), "first K3f")
        return out, sums

    def k3b(g, dsums, x, a, b, adj, cnt, out, w, relu_in):
        t, s, _ = adj.shape
        n, d = g.shape
        nblk, chunks = n // 16, -(-n // FL.BWD_CHUNK_ROWS)
        width = d * d + FL.CNT_PAD * d
        dev = dict(f32, device=g.device)
        wt = w.new_empty(d, d)
        gtc, dxw, xc, dx = (torch.empty_like(g) for _ in range(4))
        part_gt = torch.empty(nblk, d, **dev)
        part_adj = torch.empty(nblk, 2 * d, **dev)
        part_w = torch.empty(chunks, width, **dev)
        dbias = torch.empty(d, **dev)
        sums_adj = torch.empty(2 * d, **dev)
        wgrad = torch.empty(width, **dev)
        _build.check(bwd(*ptrs(g, dsums, x, a, b, adj, cnt, out, w, wt, gtc,
                               dxw, xc, part_gt, part_adj, part_w, dx, dbias,
                               sums_adj, wgrad),
                         t, s, d, int(relu_in), chunks, stream), "first K3b")
        dw, detab = wgrad.split([d * d, FL.CNT_PAD * d])
        return (dx, sums_adj[:d], sums_adj[d:], dw.view(d, d), dbias,
                detab.view(FL.CNT_PAD, d))
    return k3f, k3b


@contextlib.contextmanager
def first_libraries(libs):
    """The port's wrappers bound to the first design's libraries (for the
    kernels whose entry points did not change)."""
    saved = dict(_build._loaded)
    _build._loaded.update(libs)
    FL.kernel_fn.cache_clear()
    try:
        yield
    finally:
        _build._loaded.clear()
        _build._loaded.update(saved)
        FL.kernel_fn.cache_clear()


def bits(t: torch.Tensor) -> torch.Tensor:
    """The int32 view of an f32 tensor (int16 of a bf16 one): signed zeros
    and NaN payloads count."""
    t = t.contiguous()
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def compare(names, a, b):
    same = {k: torch.equal(bits(u), bits(v))
            for k, u, v in zip(names, a, b)}
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


def normalized(batch, x):
    """adj and cnt with the normalize_gcn weights, as the GCN trunk hands
    them to the layer (in the activation dtype)."""
    dt = x["adj"].dtype
    dis, wn = gcn_normalization(batch.nbr, batch.nbr_mask, dt)
    return dict(x, adj=normalize_tile_adjacency(x["adj"], dis).contiguous(),
                cnt=edge_counts(batch, wn).to(dt).contiguous())


def hmma_counts(lib: Path) -> dict:
    """HMMA (tensor-core) instructions in each product kernel of the built
    GCN library, from `cuobjdump -sass`."""
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(k in name for k in (
                "k5f_xw_kernel", "adj_pass_kernel", "k5b_strip_kernel",
                "wgrad_kernel")) else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def k3_kernel(name: str) -> bool:
    """Whether a mangled kernel name is one of K3f's or K3b's product
    kernels: the xw pass with the prologue, the adjacency pass with the
    moments, the strip pass with the prologue's adjoint, or the weight
    pass."""
    return (("k5f_xw_kernel" in name and "Lb1E" in name)
            or "BnMoments" in name or "BnAdjoint" in name
            or "wgrad_kernel" in name)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_gcn_bn.jsonl"))
    ap.add_argument("--no-timing", action="store_true")
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

    batches = {18: cs.real_batch("cpu"), 22: cs.pretrain_batch()[0],
               47: cs.pretrain_batch(add_hs=True)[0]}
    for t, host in batches.items():
        batch = host.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            sfx = "f32" if dt == torch.float32 else "bf16"
            old_f, old_b = first_k3(first["fused_gcn_bn"], sfx, stream)
            gen = torch.Generator().manual_seed(cs.SEED + 9)
            x0, _, pc = cs.layer_inputs(batch, dt, gen)
            n, d = x0["h"].shape
            g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
            dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
            check_t = int(x0["adj"].shape[0])
            assert check_t == t, (t, check_t)
            for norm in (False, True):
                x = normalized(batch, x0) if norm else x0
                for relu_in in (False, True):
                    fargs = (*cs.gcn_args(x, pc), relu_in)
                    tag = dict(tiles=t, dtype=sfx, normalize_gcn=norm,
                               relu_in=relu_in)
                    calls = {"first": lambda: old_f(*fargs),
                             "new": lambda: FG.fused_gcn_bn_layer_fwd(
                                 *fargs)}
                    got_old, got_new = calls["first"](), calls["new"]()
                    same, diff = compare(K3F_OUT, got_old, got_new)
                    row = dict(kernel="k3f", **tag, bit_identical=same,
                               max_abs_diff=diff)
                    timed = relu_in and not norm and not args.no_timing
                    if timed:
                        row["timing"] = timing(calls)
                    emit(row)
                    bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"],
                             x["cnt"], got_new[0], pc["w"], relu_in)
                    calls = {"first": lambda: old_b(*bargs),
                             "new": lambda: FG.fused_gcn_bn_layer_bwd(
                                 *bargs)}
                    same, diff = compare(K3B_OUT, calls["first"](),
                                         calls["new"]())
                    row = dict(kernel="k3b", **tag, bit_identical=same,
                               max_abs_diff=diff)
                    if timed:
                        row["timing"] = timing(calls)
                    emit(row)
            if t == 22:
                emit(dict(kernel="k1_k4", tiles=t, dtype=sfx,
                          **shared_code_gine(batch, dt, gen, first)))
        torch.cuda.synchronize()
    fbatch = cs.finetune_batch().to(dev)
    for dt in (torch.float32, torch.bfloat16):
        emit(dict(kernel="k5f_k5b", tiles=int(fbatch.nbr.shape[0] // 256),
                  dtype="f32" if dt == torch.float32 else "bf16",
                  **shared_code_gcn(fbatch, dt, first)))

    hmma = hmma_counts(_build._lib_path(_build.CSRC / "fused_gcn_bn.cu"))
    bf16 = {k: v for k, v in hmma.items() if "bfloat16" in k}
    f32 = {k: v for k, v in hmma.items() if "bfloat16" not in k}
    k3 = [k for k in hmma if k3_kernel(k)]
    sass_ok = (all(bf16.values()) and not any(f32.values())
               and len([k for k in k3 if "bfloat16" in k]) >= 4
               and len([k for k in k3 if "bfloat16" not in k]) >= 4)
    row = dict(kernel="sass", card=card, hmma=hmma, k3_kernels=k3,
               ok=bool(sass_ok))
    rows_out.append(row)
    print(json.dumps(row), flush=True)
    ok = ok and bool(sass_ok)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows_out))
    return 0 if ok else 1


def shared_code_gine(batch, dt, gen, first) -> dict:
    """K1f and K1b (relu_in), K4f and K4b of the two designs on the
    pretraining batch, every output compared bit for bit: they share the
    count check, the adjacency pass and the prologue's adjoint with K3."""
    x, pg, _ = cs.layer_inputs(batch, dt, gen)
    mask = FL.adj_diag_mask(x["adj"])
    n, d = x["h"].shape
    g = ((0.1 * torch.randn(n, d, generator=gen)).to(x["h"].device)
         * mask).to(dt)
    dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(x["h"].device)
    fargs = cs.gine_args(x, pg)
    uargs = (x["h"], x["adj"], x["cnt"], *fargs[5:])

    def run():
        k1f = FL.fused_gine_bn_layer_fwd(*fargs, True, residuals=True)
        out, _, agg, mid = k1f
        k1b = FL.fused_gine_bn_layer_bwd(
            g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"], agg, mid,
            out, pg["w1"], pg["w2"], True)
        k4f = FL.fused_gine_layer_fwd(*uargs, residuals=True)
        k4b = FL.fused_gine_layer_bwd(g, x["adj"], x["cnt"], k4f[1], k4f[2],
                                      pg["w1"], pg["w2"])
        return dict(k1f=k1f, k1b=k1b, k4f=k4f, k4b=k4b)

    new = run()
    with first_libraries(first):
        old = run()
    names = dict(k1f=("out", "sums", "agg", "mid"),
                 k1b=("dh", "da", "db", "dw1", "db1", "dw2", "db2", "detab"),
                 k4f=("out", "agg", "mid"),
                 k4b=("dh", "dw1", "db1", "dw2", "db2", "detab"))
    same, diff = {}, {}
    for k, ns in names.items():
        s, m = compare(ns, old[k], new[k])
        same.update({f"{k}_{n}": v for n, v in s.items()})
        diff.update({f"{k}_{n}": v for n, v in m.items()})
    return dict(bit_identical=same, max_abs_diff=diff)


def shared_code_gcn(batch, dt, first) -> dict:
    """K5f and K5b of the two designs on the fine-tuning batch, compared
    bit for bit: K3f and K3b run their launches."""
    gen = torch.Generator().manual_seed(cs.SEED + 10)
    x, _, pc = cs.layer_inputs(batch, dt, gen)
    mask = FL.adj_diag_mask(x["adj"])
    h = (x["h"].float() * mask).to(dt)
    n, d = h.shape
    g = ((0.1 * torch.randn(n, d, generator=gen)).to(h.device)
         * mask).to(dt)
    new = ((FG.fused_gcn_layer_fwd(h, x["adj"], pc["w"]),),
           FG.fused_gcn_layer_bwd(g, h, x["adj"], pc["w"]))
    with first_libraries(first):
        old = ((FG.fused_gcn_layer_fwd(h, x["adj"], pc["w"]),),
               FG.fused_gcn_layer_bwd(g, h, x["adj"], pc["w"]))
    same5f, diff5f = compare(("out",), old[0], new[0])
    same5b, diff5b = compare(("dx", "dw"), old[1], new[1])
    return dict(bit_identical={"k5f_out": same5f["out"],
                               **{f"k5b_{k}": v for k, v in same5b.items()}},
                max_abs_diff={"k5f_out": diff5f["out"],
                              **{f"k5b_{k}": v for k, v in diff5b.items()}})


if __name__ == "__main__":
    raise SystemExit(main())
