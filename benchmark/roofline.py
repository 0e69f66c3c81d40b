"""The yardstick's arithmetic: the H100's published peaks, the least time a
layer kernel's work needs (copies of the bound functions the port's
`chip_smoke.py` uses, rewritten on counts), and the model FLOPs of a
MolCLR step.

Counts come from the batch a launch took: n padded node rows in t tiles
of s rows, n_real real atoms, nnz_adj nonzeros of the tile adjacency
(each real atom's self-loop and every kept directed bond) and nnz_cnt
nonzeros of the per-atom edge-count matrix (the distinct bond types and
bond directions among an atom's kept bonds and its self-loop).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BPS = 3.35e12
PEAK_F32 = 67e12          # float32 without the tensor cores
CNT_PAD = 16              # columns of the packed edge-count matrix
F32 = 4


def _bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32, nbytes / HBM_BPS)


def gine_bn_fwd_s(n, s, n_real, nnz_adj, nnz_cnt, d, d2, es=F32):
    """K1f (fused_gine_bn_layer): the adjacency and edge-count products by
    their nonzeros, the MLP's two products over the real rows; h, out, A,
    cnt, etab and the weights read or written once, the f32 vectors."""
    t = n // s
    ops = 2 * (nnz_adj + nnz_cnt) * d + 2 * 2 * n_real * d * d2
    act = 2 * n * d + t * s * s + n * CNT_PAD + CNT_PAD * d + 2 * d * d2
    f32 = 2 * d + 2 * d + d2 + d
    return _bound_s(ops, act * es + f32 * F32)


def gine_bn_bwd_s(n, s, n_real, nnz_adj, nnz_cnt, d, d2, es=F32):
    """K1b: the four dense products over the real rows, A @ g and cnt^T g
    by their nonzeros; g, out, h, agg, dh, mid, A, cnt, W1, W2 once."""
    t = n // s
    ops = (4 * 2 * n_real * d * d2 + 2 * nnz_adj * d + 2 * nnz_cnt * d)
    act = 5 * n * d + n * d2 + t * s * s + n * CNT_PAD + 2 * d * d2
    f32 = 7 * d + d2 + 2 * d * d2 + CNT_PAD * d
    return _bound_s(ops, act * es + f32 * F32)


def gcn_bn_fwd_s(n, s, n_real, nnz_adj, nnz_cnt, d, es=F32):
    """K3f (fused_gcn_bn_layer): h @ W over the real rows, the adjacency and
    edge-count products by their nonzeros."""
    t = n // s
    ops = 2 * (nnz_adj + nnz_cnt) * d + 2 * n_real * d * d
    act = 2 * n * d + t * s * s + n * CNT_PAD + CNT_PAD * d + d * d
    f32 = 2 * d + 2 * d + d
    return _bound_s(ops, act * es + f32 * F32)


def gcn_bn_bwd_s(n, s, n_real, nnz_adj, nnz_cnt, d, es=F32):
    """K3b: dxw @ W^T and xc^T @ dxw over the real rows, A @ g and cnt^T g
    by their nonzeros."""
    t = n // s
    ops = (2 * 2 * n_real * d * d + 2 * nnz_adj * d + 2 * nnz_cnt * d)
    act = 4 * n * d + t * s * s + n * CNT_PAD + d * d
    f32 = 7 * d + d * d + CNT_PAD * d
    return _bound_s(ops, act * es + f32 * F32)


def gine_members_s(n, s, n_real, nnz_adj, nnz_cnt, d, d2, members: int,
                   backward: bool, es=F32):
    """K4f / K4b over `members` members on one batch (the member-axis
    launch): each member's products and bytes, the adjacency and the
    counts read once."""
    t = n // s
    mlp = 2 * 2 * n_real * d * d2
    sparse = 2 * nnz_adj * d + 2 * nnz_cnt * d
    shared = t * s * s + n * CNT_PAD
    weights = 2 * d * d2
    if backward:
        ops = 2 * mlp + sparse
        act = 3 * n * d + n * d2 + weights
        f32 = 2 * d * d2 + d2 + d + CNT_PAD * d
    else:
        ops = mlp + sparse
        act = 3 * n * d + n * d2 + CNT_PAD * d + weights
        f32 = d2 + d
    return _bound_s(members * ops, (shared + members * act) * es
                    + members * f32 * F32)


# ---- model FLOPs (matrix products only; elementwise work is left out) ----

def layer_flops(gnn, n_real, nnz_adj, nnz_cnt, d, d2, backward: bool):
    """One conv layer: the dense products over the real rows, the adjacency
    and edge-count products by their nonzeros; a backward pass computes
    each dense product's two gradients and the sparse products'
    transposes."""
    sparse = 2 * (nnz_adj + nnz_cnt) * d
    dense = 2 * 2 * n_real * d * d2 if gnn == "gin" else 2 * n_real * d * d
    return 2 * dense + sparse if backward else dense + sparse


def head_flops(graphs, d, feat, head: str, backward: bool):
    """feat_lin and the projection (MolCLR: feat -> feat -> feat / 2) or the
    prediction head (feat -> feat / 2 -> feat / 2 -> 2) over the real
    molecules."""
    f = 2 * graphs * d * feat
    if head == "project":
        f += 2 * graphs * feat * feat + 2 * graphs * feat * (feat // 2)
    else:
        h = feat // 2
        f += 2 * graphs * feat * h + 2 * graphs * h * h + 2 * graphs * h * 2
    return 2 * f if backward else f


def ntxent_flops(graphs, dim, backward: bool):
    """The similarity of the 2B real rows (2 (2B)^2 dim); its backward the
    two products that take the gradient back to the rows."""
    f = 2 * (2 * graphs) ** 2 * dim
    return 2 * f if backward else f
