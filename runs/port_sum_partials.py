"""The fixed-order partial sums of csrc/fused_bn_common.cuh, on the card:
one thread per column against blocks that stage rows in shared memory.

    python3 runs/port_sum_partials.py [--out FILE]   (repository root, card)

Every backward and K1f / K3f end with sums[i] = sum over rows, in row
order, of partial[row, i]. Two kernels compute it with the same order of
f32 additions:
  * column: one thread per column, loads 16 rows at a time (`fbl::
    sum_partials`, which `launch_sum_partials` takes outside the tiled
    kernel's range; copied here so that the comparison does not depend on
    which kernels the header keeps);
  * tiled: `fbl::sum_partials_tiled`, a block of SUM_NT threads per 32
    columns whose warps stage up to SUM_ROWS rows in shared memory and
    whose first warp adds them in row order.
Both are built from the checkout's header with nvcc into build/ (a
git-ignored directory) and called through ctypes on random partials of
every (rows, width) below: the rows of the main paths (weight-pass
chunks of K1b / K4b, K5b and K3b; strip partials of batches of T = 1 to
44 tiles) and around them. For each shape the script checks that the two
results are bit-identical and reads each kernel's device us per call
(torch.profiler over 20 calls of each, interleaved, warm L2 as after the
launch that wrote the partials). Prints one JSON line per shape, the card
(`nvidia-smi`) and the rows from which the tiled kernel is no slower at
each width; writes them all to --out. Exits 1 if any result differs."""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from molclr_tpu_torch.ops import _build  # noqa: E402

SOURCE = r"""
#include "HEADER"

// one thread per column, its loads 16 rows at a time, rows in order
static __global__ void column_sum(const float* __restrict__ partial,
                                  float* __restrict__ sums, int nblk,
                                  int width) {
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

extern "C" int sum_column(const float* p, float* s, int nblk, int width,
                          void* stream) {
  column_sum<<<(width + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      p, s, nblk, width);
  return (int)cudaGetLastError();
}

extern "C" int sum_tiled(const float* p, float* s, int nblk, int width,
                         void* stream) {
  fbl::sum_partials_tiled<<<(width + 31) / 32, fbl::SUM_NT, 0,
                            (cudaStream_t)stream>>>(p, s, nblk, width);
  return (int)cudaGetLastError();
}
"""

# widths: K1b's [da | db] and K1f's moments (2 D at D = 300), K1b's [db1 |
# db2] (D2 + D), the same at wider layers (to D = 1,024 and beyond),
# K5b's dW (300 x 300), K3b's [dW | detab], K1b / K4b's [dW1 | dW2 |
# detab] (D2 = 600, CNT_PAD = 16)
WIDTHS = (600, 900, 2_048, 3_072, 4_096, 8_192, 16_384, 32_768, 90_000,
          94_800, 364_800)
# rows: weight-pass chunks (1 to 11, and K5b's / bf16's chunk counts),
# strip partials of T = 1, 2, 3, 4, 6, 18, 22 and 44 tiles of 256
ROWS = (1, 2, 3, 4, 6, 8, 11, 16, 24, 32, 48, 64, 96, 128, 288, 352, 704)


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "sum_partials"
    out.mkdir(parents=True, exist_ok=True)
    header = ROOT / "molclr_tpu_torch" / "csrc" / "fused_bn_common.cuh"
    src = out / "bench.cu"
    src.write_text(SOURCE.replace("HEADER", str(header)))
    lib = out / "libsum_partials.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib))
    for name in ("sum_column", "sum_tiled"):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def device_us(calls: dict, reps: int = 20) -> dict:
    """Device us per call of each named launch, the launches interleaved,
    from torch.profiler's kernel records."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in calls.values():
                fn()
        torch.cuda.synchronize()
    got = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        for name in calls:
            kernel = "column_sum" if name == "column" else "sum_partials_tiled"
            if kernel in e.key and us:
                got[name] = us / reps
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "port_sum_partials.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_sum_partials: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok, rows_out = True, []
    for width in WIDTHS:
        for nblk in ROWS:
            part = torch.randn(nblk, width, device="cuda", generator=gen)
            sums = {k: torch.empty(width, device="cuda")
                    for k in ("column", "tiled")}

            def launch(name, fn):
                return lambda: _build.check(
                    fn(part.data_ptr(), sums[name].data_ptr(), nblk, width,
                       stream), name)

            calls = {"column": launch("column", lib.sum_column),
                     "tiled": launch("tiled", lib.sum_tiled)}
            us = device_us(calls)
            same = torch.equal(sums["column"], sums["tiled"])
            ok &= same
            row = dict(card=card, rows=nblk, width=width, bit_identical=same,
                       column_us=us.get("column"), tiled_us=us.get("tiled"))
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    # per width, the fewest rows from which the tiled kernel is no slower
    # at every row count measured (None: slower at the most rows)
    crossover = {}
    for width in WIDTHS:
        rows = [r for r in rows_out if r["width"] == width]
        start = None
        for r in reversed(rows):
            if (r["tiled_us"] or float("inf")) > (r["column_us"] or 0.0):
                break
            start = r["rows"]
        crossover[width] = start
    summary = dict(card=card, tiled_no_slower_from_rows=crossover)
    print(json.dumps(summary), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("".join(json.dumps(r) + "\n"
                                for r in rows_out + [summary]))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
