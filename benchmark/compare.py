"""The numbers that decide `correct`: gaps between the program's readings
and the reference's, each a share of the reference's scale."""

from __future__ import annotations

import math

import torch


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in d.items()}


def rel_gap(prog: list, ref: list) -> float:
    """The widest |prog - ref| / |ref| over paired scalars (inf where the
    program's reading is not finite)."""
    worst = 0.0
    for a, b in zip(prog, ref, strict=True):
        if not math.isfinite(a):
            return math.inf
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def moved(ref_grad: dict, frac: float = 1e-3) -> list:
    """The leaves whose reference gradient norm is at least `frac` of the
    median leaf's: a leaf below that (a bias under a normalization) moves
    under Adam by round-off alone."""
    norms = _norms(ref_grad)
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= frac * med]


def leaf_norm_gap(prog: dict, ref: dict, keys=None) -> tuple[float, str]:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm(ref)), and that leaf's name."""
    keys = list(ref) if keys is None else list(keys)
    rn = _norms({k: ref[k] for k in keys})
    pn = _norms({k: prog[k] for k in keys})
    med = sorted(rn.values())[len(rn) // 2]
    worst, at = 0.0, ""
    for k in keys:
        if not math.isfinite(pn[k]):
            return math.inf, k
        g = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at


def max_rel_diff(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| over max |ref|."""
    if not bool(torch.isfinite(prog).all()):
        return math.inf
    scale = float(ref.abs().max())
    return float((prog.double() - ref.double()).abs().max()) / max(scale,
                                                                  1e-30)
