"""The Graphormer cell's yardstick: the model FLOPs of a step and the least
time of its attention's work, from counts of the batch (the H100 peaks of
benchmark/roofline.py).

Counts: `rows`, the real rows of a batch (atoms and one graph token per
molecule); `pairs`, the pairs of rows the molecules need, the sum over
them of (atoms + 1)^2; `graphs`, its molecules. Widths: d (hidden), f
(feed-forward), heads, layers, out (the head's outputs).

Model FLOPs count the matrix products over the real rows (q, k, v and
the output projection, the two feed-forward layers), the attention over
the real pairs (q k^T and the probabilities times v, d multiply-adds a
pair each), and the readout head over the molecules; a backward pass
computes two products for each forward one. Elementwise work (norms,
softmax, dropout, the bias's gathers) is left out.
"""

from __future__ import annotations

from benchmark.roofline import F32, HBM_BPS, PEAK_F32


def attention_flops(pairs: int, d: int, backward: bool) -> float:
    """One layer's attention over `pairs`: q k^T and p v forward; p^T g,
    g v^T, ds k and ds^T q backward."""
    return (8 if backward else 4) * pairs * d


def attention_bytes(rows: int, pairs: int, d: int, heads: int,
                    backward: bool) -> float:
    """What one layer's attention must read and write once, f32: forward
    q, k, v and the bias in, the output out; backward q, k, v, the output
    gradient and the bias in, the gradients of q, k, v and the bias out."""
    if backward:
        return F32 * (8 * rows * d + 2 * pairs * heads)
    return F32 * (4 * rows * d + pairs * heads)


def attention_bound_s(rows: int, pairs: int, d: int, heads: int,
                      backward: bool) -> float:
    """The least time of one layer's attention: the larger of its FLOPs at
    the f32 peak and its bytes at the HBM rate."""
    return max(attention_flops(pairs, d, backward) / PEAK_F32,
               attention_bytes(rows, pairs, d, heads, backward) / HBM_BPS)


def step_flops(rows: int, pairs: int, graphs: int, *, d: int, f: int,
               layers: int, out: int, backward: bool) -> float:
    """Model FLOPs of one batch (module docstring), forward and, with
    `backward`, the backward pass."""
    layer = 2 * rows * (4 * d * d + 2 * d * f) \
        + attention_flops(pairs, d, False)
    head = 2 * graphs * (d * d + d * out)
    fwd = layers * layer + head
    if not backward:
        return fwd
    return fwd + 2 * (layers * (layer - attention_flops(pairs, d, False))
                      + head) + layers * attention_flops(pairs, d, True)
