"""Building blocks: masked BatchNorm in coefficient mode and the GINE / GCN
convolutions of the BN-chained fused path.

Port of molclr_tpu/models/layers.py. Parameter names and initializers
follow the reference torch models (ginet_molclr.py, gcn_molclr.py), so a
reference state dict loads directly:
  GINEConv  mlp = Linear(D, 2D), ReLU, Linear(2D, D); edge_embedding1 [5, D],
            edge_embedding2 [3, D] (xavier uniform); message x_j + e, sum
            aggregation incl. the type-4 self-loop, no epsilon.
  GCNConv   weight [D, D] used as x @ W (uniform +-sqrt(6 / 2D)), bias [D]
            (zeros), scalar edge embeddings [5, 1] and [3, 1]; the
            reference's discarded normalization (quirk Q2) is reproduced
            unless normalize (normalize_gcn) applies it.
  BatchNorm torch BatchNorm1d semantics (eps 1e-5, momentum 0.1, biased
            variance to normalize, unbiased in the running stats) over
            real nodes only.
Each conv has two fused modes on the tile-dense trunk, as in the JAX
package: BN-chained (it takes the previous BatchNorm's affine (a, b,
relu_in) as its prologue and returns its output with the masked moments
that feed the next MaskedBatchNorm), and unchained (one fused layer call;
BatchNorm, relu and dropout follow outside the kernel), which the trunk
runs when drop_ratio > 0; `members_forward` runs the unchained mode of M
convs of one configuration (an ensemble's members) as one member-axis
kernel call, the JAX FineTuner's vmapped layer. Without an adjacency (the
ELL trunk, tile 0)
each conv aggregates over the batch's ELL view with
ops/scatter_free.py's gine_aggregate / gcn_aggregate and runs its dense
parts as PyTorch ops, the JAX layers' path without the fused kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from molclr_tpu_torch.data.featurize import NUM_BOND_DIRS, NUM_BOND_TYPES
from molclr_tpu_torch.ops.fused_gcn import (
    fused_gcn_bn_layer,
    fused_gcn_layer,
    fused_gcn_layer_members,
    pack_gcn_etab,
)
from molclr_tpu_torch.ops.fused_layer import (
    fused_gine_bn_layer,
    fused_gine_layer,
    fused_gine_layer_members,
    pack_cnt,
    pack_etab,
)
from molclr_tpu_torch.ops.scatter_free import _counts, gcn_aggregate, \
    gine_aggregate
from molclr_tpu_torch.ops.tile_dense import (
    gcn_edge_term,
    gcn_normalization,
    normalize_tile_adjacency,
)


def edge_counts(batch, w: torch.Tensor) -> torch.Tensor:
    """The packed per-node edge count matrix [N, CNT_PAD] of the ELL view
    with slot weights w [N, K] (the mask, or the normalized mask), in w's
    dtype."""
    return pack_cnt(_counts(batch.nbr_bond_type, w, NUM_BOND_TYPES),
                    _counts(batch.nbr_bond_dir, w, NUM_BOND_DIRS))


def linear_in(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """Dense layer computed in `dtype` with f32 parameters cast to it (the
    JAX package's dense(dtype=...) semantics)."""
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype),
                                lin.bias.to(dtype))


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """torch nn.init.xavier_uniform_ on a 2-D tensor [fan_out, fan_in]:
    U(+-sqrt(6 / (fan_in + fan_out)))."""
    bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def reset_linear_(lin: nn.Linear, generator=None) -> nn.Linear:
    """torch nn.Linear default init (kaiming_uniform(a=sqrt(5)) ==
    U(+-1/sqrt(fan_in)) for weight and bias), drawn from `generator`."""
    bound = 1.0 / lin.in_features ** 0.5
    lin.weight.uniform_(-bound, bound, generator=generator)
    if lin.bias is not None:
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the real nodes, with the JAX package's two modes.

    bn(x, mask)               classic: statistics from the rows of x where
                              mask is True; returns the normalized x, zero
                              on the other rows (the unchained trunk).
    bn((total, total_sq, count))
                              coefficient mode for the BN-chained kernels:
                              statistics from the masked moments the
                              previous kernel accumulated; returns the f32
                              affine pair (a, b) with normalize(x) == x*a+b.
    Training mode takes the batch statistics and updates the running stats
    in place; eval mode uses the running stats. Under data parallelism
    (dp, a parallel.DPGroup: the JAX layer's axis_name) training mode sums
    the moments (total, total_sq, count) across the ranks first, in one
    differentiable all_reduce, so every rank normalizes with the global
    batch's statistics and keeps the same running stats."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dp=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dp = dp
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def _mean_inv(self, total, total_sq, count):
        """(mean, 1 / sqrt(var + eps)) of the batch in training mode (and
        the running-stat update), of the running stats in eval mode."""
        if self.training:
            if self.dp is not None:
                from molclr_tpu_torch.parallel.dp import sum_across_ranks

                d = total.shape[0]
                summed = sum_across_ranks(torch.cat(
                    [total, total_sq, count.reshape(1)]), self.dp)
                total, total_sq, count = (summed[:d], summed[d: 2 * d],
                                          summed[2 * d])
            count = torch.clamp(count, min=1.0)
            mean = total / count
            var = torch.clamp(total_sq / count - mean ** 2, min=0.0)
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return mean, torch.rsqrt(var + self.eps)

    def forward(self, x, mask=None):
        if isinstance(x, tuple):
            mean, inv = self._mean_inv(*x)
            a = inv * self.weight
            return a, self.bias - mean * a
        m = mask.float()[:, None]
        xf = x.float()
        mean, inv = self._mean_inv((xf * m).sum(dim=0),
                                   (xf ** 2 * m).sum(dim=0), m.sum())
        # the JAX package's casts: a bf16 x meets the f32 scale and bias,
        # so the result is f32
        y = (x - mean.to(x.dtype)) * (inv.to(x.dtype) * self.weight) \
            + self.bias
        return torch.where(mask[:, None], y, 0)


class GINEConv(nn.Module):
    """GINE convolution (no epsilon) in its two fused modes."""

    def __init__(self, emb_dim: int, generator=None):
        super().__init__()
        d = emb_dim
        self.mlp = nn.Sequential(nn.Linear(d, 2 * d), nn.ReLU(),
                                 nn.Linear(2 * d, d))
        self.edge_embedding1 = nn.Embedding(NUM_BOND_TYPES, d)
        self.edge_embedding2 = nn.Embedding(NUM_BOND_DIRS, d)
        reset_linear_(self.mlp[0], generator)
        reset_linear_(self.mlp[2], generator)
        xavier_uniform_(self.edge_embedding1.weight, generator)
        xavier_uniform_(self.edge_embedding2.weight, generator)

    def forward(self, h, adj, cnt, bn_in=None, batch=None):
        """h [N, D]; adj/cnt from the trunk. With bn_in = (a, b, relu_in)
        of the previous BatchNorm (h its raw input) the BN-chained kernel
        runs and returns (out [N, D], sums [2, D]); without it the
        unchained kernel returns out [N, D]; with adj None, `batch`'s ELL
        view is aggregated by gine_aggregate and the MLP follows. All
        compute in h's dtype."""
        dt = h.dtype
        lin0, lin1 = self.mlp[0], self.mlp[2]
        if adj is None:
            agg = gine_aggregate(
                h, self.edge_embedding1.weight.to(dt),
                self.edge_embedding2.weight.to(dt), batch.nbr,
                batch.nbr_bond_type, batch.nbr_bond_dir, batch.nbr_mask)
            return linear_in(lin1, torch.relu(linear_in(lin0, agg, dt)), dt)
        etab, w1, b1, w2, b2 = (x.contiguous()
                                for x in self.kernel_params(dt))
        if bn_in is None:
            return fused_gine_layer(h, adj.to(dt), cnt.to(dt), etab, w1, b1,
                                    w2, b2)
        a, b, relu_in = bn_in
        return fused_gine_bn_layer(h, a, b, adj, cnt.to(dt), etab, w1, b1,
                                   w2, b2, relu_in)

    def kernel_params(self, dt):
        """The fused kernels' (etab, W1, b1, W2, b2): the edge tables and
        the MLP's weights [in, out] in dtype dt, the biases f32."""
        lin0, lin1 = self.mlp[0], self.mlp[2]
        return (pack_etab(self.edge_embedding1.weight,
                          self.edge_embedding2.weight, dt),
                lin0.weight.t().to(dt), lin0.bias.float(),
                lin1.weight.t().to(dt), lin1.bias.float())

    @staticmethod
    def members_forward(convs, hs, adj, cnt, batch=None):
        """The unchained mode of M convs on one batch: their inputs hs and
        kernel parameters stacked, one fused_gine_layer_members call, each
        member's output [N, D] (what conv(h, adj, cnt) gives, bit for
        bit)."""
        dt = hs[0].dtype
        params = (torch.stack(x) for x in zip(
            *(c.kernel_params(dt) for c in convs)))
        return fused_gine_layer_members(torch.stack(hs), adj.to(dt),
                                        cnt.to(dt), *params).unbind(0)


class GCNConv(nn.Module):
    """GCN convolution with scalar edge embeddings in its two fused modes.
    normalize=False reproduces the reference's discarded normalization
    (quirk Q2); normalize=True applies the symmetric normalization from
    the masked degree including the self-loop."""

    def __init__(self, emb_dim: int, generator=None, normalize: bool = False):
        super().__init__()
        d = emb_dim
        self.normalize = normalize
        self.weight = nn.Parameter(torch.empty(d, d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.edge_embedding1 = nn.Embedding(NUM_BOND_TYPES, 1)
        self.edge_embedding2 = nn.Embedding(NUM_BOND_DIRS, 1)
        bound = (6.0 / (2 * d)) ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
        xavier_uniform_(self.edge_embedding1.weight, generator)
        xavier_uniform_(self.edge_embedding2.weight, generator)

    def forward(self, h, adj, cnt, bn_in=None, batch=None):
        """As GINEConv.forward. The unchained mode runs A @ (h @ W) as one
        kernel call and adds the scalar edge term and the bias outside it,
        in h's dtype, as the JAX package does; with normalize it scales adj
        and weights the counts itself, from `batch`'s ELL view in h's dtype
        (as the JAX layer does per layer). The BN-chained mode takes adj
        and cnt already normalized by the trunk. With adj None, x = h @ W
        is aggregated over `batch`'s ELL view by gcn_aggregate."""
        dt = h.dtype
        e1, e2 = self.edge_embedding1.weight, self.edge_embedding2.weight
        w = self.weight.to(dt).contiguous()
        if adj is None:
            norm = None
            if self.normalize:
                # mask * dis[nbr] * dis[n]: the same slot weights as the
                # unmasked norm, the mask being 0 or 1
                _, norm = gcn_normalization(batch.nbr, batch.nbr_mask, dt)
            out = gcn_aggregate(h @ w, e1.to(dt), e2.to(dt), batch.nbr,
                                batch.nbr_bond_type, batch.nbr_bond_dir,
                                batch.nbr_mask, norm)
            return out + self.bias.to(dt)
        if bn_in is None:
            adj, cnt = self.unchained_graph(adj, cnt, batch, dt)
            out = fused_gcn_layer(h, adj.to(dt), w)
            return self.edge_and_bias(out, cnt)
        a, b, relu_in = bn_in
        return fused_gcn_bn_layer(
            h, a, b, adj, cnt.to(dt), pack_gcn_etab(e1, e2, h.shape[1], dt),
            w, self.bias.float(), relu_in)

    def unchained_graph(self, adj, cnt, batch, dt):
        """The unchained mode's adjacency and counts: with normalize, adj
        scaled and the counts weighted from `batch`'s ELL view in dtype dt
        (as the JAX layer does per layer); else as given."""
        if not self.normalize:
            return adj, cnt
        dis, wn = gcn_normalization(batch.nbr, batch.nbr_mask, dt)
        return normalize_tile_adjacency(adj, dis), edge_counts(batch, wn)

    def edge_and_bias(self, out, cnt):
        """The unchained mode's scalar edge term and bias added to the
        kernel's A @ (h @ W), in out's dtype."""
        dt = out.dtype
        return (out + gcn_edge_term(self.edge_embedding1.weight,
                                    self.edge_embedding2.weight, cnt, dt)
                + self.bias.to(dt))

    @staticmethod
    def members_forward(convs, hs, adj, cnt, batch=None):
        """The unchained mode of M convs of one configuration on one batch:
        their inputs and weights stacked, one fused_gcn_layer_members call,
        then each member's edge term and bias (what conv(h, adj, cnt,
        batch=batch) gives, bit for bit)."""
        dt = hs[0].dtype
        adj, cnt = convs[0].unchained_graph(adj, cnt, batch, dt)
        out = fused_gcn_layer_members(
            torch.stack(hs), adj.to(dt),
            torch.stack([c.weight.to(dt) for c in convs]))
        return [c.edge_and_bias(o, cnt) for c, o in zip(convs, out.unbind(0))]
