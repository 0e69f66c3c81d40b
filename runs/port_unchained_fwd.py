"""K4f and K5f against their first design, on the card, in one process.

    python3 runs/port_unchained_fwd.py --parent DIR   (repository root, card)

DIR holds the first design's kernel sources (molclr_tpu_torch/csrc/ of the
commit before the redesign, e.g. `git archive <commit>
molclr_tpu_torch/csrc | tar -x -C DIR`). They are built with nvcc into
DIR/build/ and called through ctypes with the first design's entry points
gine_fwd_<t>(h, adj, cnt, etab, w1, b1, w2, b2, out, agg, mid, T, S, D, D2,
stream) and gcn_fwd_<t>(x, adj, w, xw, out, T, S, D, stream).

At the fine-tuning shapes (T = 4: a training batch of 32 molecules with
hydrogens, as chip_smoke.py phase 8 packs it; T = 6: an eval batch of 32,
'max' sizing over the whole stand-in), in f32 and bf16, on chip_smoke.py's
full-width layer inputs:
  * K4f's out, agg, mid and K5f's out of the two designs, compared bit for
    bit (the f32 ones must be equal: the redesign keeps the order of every
    f32 sum; the script exits 1 otherwise);
  * CUDA-event ms, device us (torch.profiler over 20 calls) and host us
    per call of the first design and of the wrapper, timed first, new,
    new, first.
Prints one JSON line per (T, dtype) and writes them all to --out."""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402
from molclr_tpu_torch.ops import fused_gcn as FG  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402


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
    return [None if t is None else t.data_ptr() for t in ts]


def eval_batch():
    """An eval batch at the fine-tuning shape: the FineTuner's eval spec
    ('max' sizing over the stand-in) on its first 32 molecules."""
    graphs, _ = cs.featurize_many(cs.synthetic_corpus(cs.FT_MOLS,
                                                      seed=cs.SEED),
                                  add_hs=True)
    spec = cs.spec_for_graphs(graphs, cs.FT_BATCH, tile=cs.TILE,
                              sizing="max")
    return cs.pack_batch(graphs[:cs.FT_BATCH], spec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_unchained_fwd.jsonl"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    first = build_first_design(args.parent)
    _build.build_all()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_out, ok = [], True
    for batch in (cs.finetune_batch(), eval_batch()):
        batch = batch.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            sfx = "f32" if dt == torch.float32 else "bf16"
            gen = torch.Generator().manual_seed(cs.SEED + 4)
            x, pg, pc = cs.layer_inputs(batch, dt, gen)
            x["h"] = (x["h"].float() * FL.adj_diag_mask(x["adj"])).to(dt)
            h, adj, cnt = x["h"], x["adj"], x["cnt"]
            t, s, _ = adj.shape
            n, d = h.shape
            d2 = pg["w1"].shape[1]
            fargs = (h, adj, cnt, pg["etab"], pg["w1"], pg["b1"], pg["w2"],
                     pg["b2"])
            old_gine = entry(first["fused_gine_bn"], f"gine_fwd_{sfx}", 11, 4)
            old_gcn = entry(first["fused_gcn_bn"], f"gcn_fwd_{sfx}", 5, 3)

            def k4f_first():
                out, agg, mid = (torch.empty_like(h), torch.empty_like(h),
                                 h.new_empty(n, d2))
                _build.check(old_gine(*ptrs(*fargs, out, agg, mid), t, s, d,
                                      d2, stream), "first K4f")
                return out, agg, mid

            def k5f_first():
                xw, out = torch.empty_like(h), torch.empty_like(h)
                _build.check(old_gcn(*ptrs(h, adj, pc["w"], xw, out), t, s,
                                     d, stream), "first K5f")
                return out

            k4f_new = lambda: FL.fused_gine_layer_fwd(  # noqa: E731
                *fargs, residuals=True)
            k5f_new = lambda: FG.fused_gcn_layer_fwd(  # noqa: E731
                h, adj, pc["w"])
            a, b = k4f_first(), k4f_new()
            c, e = k5f_first(), k5f_new()
            torch.cuda.synchronize()
            same = {f"k4f_{k}": torch.equal(u, v)
                    for k, u, v in zip(("out", "agg", "mid"), a, b)}
            same["k5f_out"] = torch.equal(c, e)
            diff = {f"k4f_{k}": (u.float() - v.float()).abs().max().item()
                    for k, u, v in zip(("out", "agg", "mid"), a, b)}
            diff["k5f_out"] = (c.float() - e.float()).abs().max().item()
            if dt == torch.float32 and not all(same.values()):
                ok = False

            timing = {}
            for kern, calls in (("k4f", {"first": k4f_first, "new": k4f_new}),
                                ("k5f", {"first": k5f_first, "new": k5f_new})):
                res = {k: dict(ms=[]) for k in calls}
                for k in ("first", "new", "new", "first"):
                    res[k]["ms"].append(cs.time_ms(calls[k]))
                for k in calls:
                    res[k]["device_us"] = cs.pass_profile(calls[k])
                    res[k]["device_us_total"] = sum(
                        res[k]["device_us"].values())
                    res[k]["host_us"] = cs.host_us(calls[k])
                timing[kern] = res
            row = dict(card=card, tiles=t, dtype=sfx,
                       bit_identical=same, max_abs_diff=diff, timing=timing)
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows_out))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
