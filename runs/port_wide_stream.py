"""The layer kernels at the reference width against the parent commit's,
on the card, in one process: what streaming the wide layers' [16, D]
operands must leave as it was.

    python3 runs/port_wide_stream.py --parent DIR [--out FILE] [--no-timing]
                                                  (repository root, card)

DIR holds the parent commit's kernel sources (`git archive <commit>
molclr_tpu_torch/csrc | tar -x -C DIR`, DIR under a git-ignored directory
such as build/). They are built with nvcc (this checkout's flags, -Xptxas
-v included) into DIR/build/, and the port's wrappers are bound to them in
turn with this checkout's libraries: the C entry points are the same.
  * ptxas: every kernel instantiation of the parent's three layer
    libraries against this checkout's instantiation of the same kernel
    (its new STREAM / RELU template parameters false): registers, spill
    stores and spill loads, which must be equal;
  * outputs at D = 300, D2 = 600 (tile 256): K1f, K1b, K3f and K3b (relu_in
    on) at the pretraining batch (T = 22), K4f, K4b, K5f and K5b at the
    fine-tuning batch (T = 4) and their member-axis launches at M = 3, on
    chip_smoke.py's full-width layer inputs, f32 and bf16: every output of
    the two builds bit for bit;
  * outputs at D = 2,048, D2 = 4,096 (tiles 128 and 256), phase 8's wide
    inputs (chip_smoke.wide_calls on its WIDE_MOLS molecules): the eight
    layer kernels, f32 bit for bit, bf16 within KERNEL_RTOL of the
    parent's (where K1f splits, the parent computes mid in the split block
    and this checkout in the streamed mid launch);
  * unless --no-timing, each call's CUDA-event ms (chip_smoke.time_ms) in
    the order parent, change, change, parent.
Prints one JSON line per case and writes them all to --out; exits 1 where
an output or a register or spill count differs."""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402

LIBS = ("fused_gine_bn", "fused_gine_bwd", "fused_gcn_bn")
MEMBERS = 3
WIDE_D = 2048


def build_parent(parent: Path) -> dict:
    """{library: (CDLL, nvcc's log)} of the parent's sources, built in
    parallel."""
    src = parent / "molclr_tpu_torch" / "csrc"
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: (out / f"lib{name}.so", subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(src / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for name in LIBS}
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {log}")
        libs[name] = (ctypes.CDLL(str(lib)), log)
    return libs


def ptxas(log: str) -> dict:
    """{demangled kernel: (registers, spill stores, spill loads)} of an
    nvcc -Xptxas -v log."""
    out, cur = {}, None
    spill = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spill[cur] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spill.get(cur, (0, 0)))
    names = list(out)
    filt = shutil.which("c++filt")
    if filt and names:
        dem = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True).stdout.splitlines()
    else:
        dem = names
    return {d.split("(")[0].removeprefix("void "): out[n]
            for n, d in zip(names, dem)}


def match_ptxas(parent: dict, change: dict) -> list:
    """Each parent kernel beside this checkout's instantiation of it: the
    same name once trailing `false` template arguments (parameters added or
    removed since, false where the instantiation does not use them) are
    dropped from both."""
    def base(name: str) -> str:
        while name.endswith(", false>"):
            name = name[: -len(", false>")] + ">"
        return name

    theirs = {base(n): v for n, v in parent.items()}
    return [dict(kernel=name, parent=theirs[base(name)], change=got)
            for name, got in sorted(change.items()) if base(name) in theirs]


def calls(dev, dt, gen) -> dict:
    """{name: (output names, kernel call)}: chip_smoke.wide_calls at the
    reference width on the pretraining batch (the BN-chained kernels) and
    the fine-tuning batch (the unchained ones), and the member-axis
    launches at M = MEMBERS."""
    pre = cs.pretrain_batch()[0].to(dev)
    ft = cs.finetune_batch().to(dev)
    out = {}
    for batch, keep in ((pre, "_bn_"), (ft, None)):
        x, pg, pc = cs.layer_inputs(batch, dt, gen)
        n, d = x["h"].shape
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
        dsums = (0.05 * torch.randn(2, d, generator=gen)).to(dev)
        for name, (names, run, *_rest) in cs.wide_calls(
                x, pg, pc, g, dsums, dt).items():
            if (keep is None) == ("_bn_" not in name):
                out[name] = (names, run)
    for name, (names, run, _) in cs.wide_member_calls(
            ft, dt, gen, cs.EMB, cs.TILE, MEMBERS).items():
        out[name] = (names, run)
    return out


def wide(dev, dt, gen) -> dict:
    """{name: (output names, kernel call)}: chip_smoke.wide_calls at D =
    WIDE_D, D2 = 2 D, tiles 128 and 256, on phase 8's molecules."""
    graphs, _ = cs.featurize_many(cs.synthetic_corpus(cs.WIDE_MOLS,
                                                      seed=cs.SEED))
    out = {}
    for tile in (128, cs.TILE):
        batch = cs.pack_batch(graphs, cs.spec_for_graphs(
            graphs, cs.WIDE_MOLS, tile=tile)).to(dev)
        x, pg, pc = cs.layer_inputs(batch, dt, gen, WIDE_D, tile)
        n = x["h"].shape[0]
        g = (0.1 * torch.randn(n, WIDE_D, generator=gen)).to(dev, dt)
        dsums = (0.05 * torch.randn(2, WIDE_D, generator=gen)).to(dev)
        for name, (names, run, *_rest) in cs.wide_calls(
                x, pg, pc, g, dsums, dt).items():
            out[f"{name}@{WIDE_D}/{tile}"] = (names, run)
    return out


def bind(libs: dict) -> None:
    """Bind the wrappers to `libs` ({library: CDLL})."""
    _build._loaded.update(libs)
    for f in (FL.kernel_fn, FL.strip_rows, FL.k1f_block_rows,
              FL.k1f_splits):
        f.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/port_wide_stream.jsonl"))
    ap.add_argument("--no-timing", action="store_true")
    args = ap.parse_args()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, ok = [], True

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit(dict(card=cs.card_line(), build_s=_build.build_all()))
    parent = build_parent(args.parent)
    mine = {name: _build.load(name) for name in LIBS}
    for name in LIBS:
        log = (_build._lib_path(_build.CSRC / f"{name}.cu")
               .with_suffix(".log").read_text())
        for r in match_ptxas(ptxas(parent[name][1]), ptxas(log)):
            same = r["parent"] == r["change"]
            ok &= same
            emit(dict(r, library=name, same=same))
    theirs = {name: lib for name, (lib, _) in parent.items()}
    streams_agg = FL.gine_streams_agg
    for dt in (torch.float32, torch.bfloat16):
        sfx = str(dt).replace("torch.", "")
        cases = calls(dev, dt, torch.Generator().manual_seed(cs.SEED + 11))
        cases.update(wide(dev, dt, torch.Generator().manual_seed(
            cs.SEED + 13)))
        for name, (names, run) in cases.items():
            bind(mine)
            FL.gine_streams_agg = streams_agg
            got = cs._tuple(run())
            bind(theirs)
            # (the parent's libraries have no such query; up to D = 2,048
            # K4f does not stream agg)
            FL.gine_streams_agg = lambda *a: False
            want = cs._tuple(run())
            torch.cuda.synchronize()
            same = {o: torch.equal(u, v) for o, u, v in zip(names, got, want)}
            row = dict(kernel=name, dtype=sfx, equal=same)
            if "@" in name and dt == torch.bfloat16:
                rel = {o: (u.float() - v.float()).abs().max().item()
                       / max(v.float().abs().max().item(), 1e-30)
                       for o, u, v in zip(names, got, want)}
                row["rel_err"] = rel
                ok &= max(rel.values()) <= cs.KERNEL_RTOL[dt]
            else:
                ok &= all(same.values())
            if not args.no_timing:
                ms = []
                for libs in (theirs, mine, mine, theirs):
                    bind(libs)
                    FL.gine_streams_agg = (streams_agg if libs is mine
                                           else (lambda *a: False))
                    ms.append(cs.time_ms(run))
                row.update(parent_ms=[ms[0], ms[3]], change_ms=ms[1:3])
            emit(row)
    bind(mine)
    FL.gine_streams_agg = streams_agg
    emit(dict(ok=ok))
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
