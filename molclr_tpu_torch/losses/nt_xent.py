"""NT-Xent (normalized temperature-scaled cross-entropy) contrastive loss,
closed form.

Port of molclr_tpu/losses/nt_xent.py. Under data parallelism (dp, a
parallel.DPGroup) both views and the pair mask are first gathered from
every rank, so the negatives span the global batch and every rank computes
the same loss (JAX's all_gather over the mesh axis). With representations
r = [zjs; zis] (2B rows) and pairwise similarity s,

    loss_i = -s(i, partner(i))/T + logsumexp_{j != i} s(i, j)/T
    loss   = mean_i loss_i

over the valid rows; pair_mask [B] marks real pairs, and masked pairs
contribute neither positives nor negatives.
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops.ntxent import cosine_normalize


def nt_xent_loss(zis: torch.Tensor, zjs: torch.Tensor,
                 temperature: float = 0.1, use_cosine: bool = True,
                 pair_mask: torch.Tensor | None = None,
                 dp=None) -> torch.Tensor:
    """zis, zjs: [B, D] projections of the two augmented views; pair_mask:
    optional [B] bool of real (non-padding) pairs; dp: the DPGroup whose
    ranks' pairs are gathered first. Returns the scalar loss."""
    if dp is not None:
        from molclr_tpu_torch.parallel.dp import gather_pairs

        zis, zjs, pair_mask = gather_pairs(zis, zjs, pair_mask, dp)
    b = zis.shape[0]
    reps = torch.cat([zjs, zis], dim=0)           # [2B, D], reference order
    if use_cosine:
        reps = cosine_normalize(reps)
    sim = (reps @ reps.t()) / temperature         # [2B, 2B]
    n = 2 * b
    # the positive logits s(i, i + B) and s(i + B, i): two diagonals, so the
    # backward is a strided copy, not a scatter
    pos = torch.cat([torch.diagonal(sim, offset=b),
                     torch.diagonal(sim, offset=-b)])
    dead = torch.eye(n, dtype=torch.bool, device=reps.device)
    if pair_mask is not None:
        row_mask = torch.cat([pair_mask, pair_mask]).bool()
        dead = dead | ~row_mask[None, :]
    denom = torch.logsumexp(sim.masked_fill(dead, float("-inf")), dim=-1)
    per_row = denom - pos
    if pair_mask is None:
        return per_row.mean()
    row_mask = torch.cat([pair_mask, pair_mask]).to(per_row.dtype)
    return (per_row * row_mask).sum() / torch.clamp(row_mask.sum(), min=1.0)
