"""Contrastive losses: the NT-Xent closed form and the choice between it and
the hand-written kernel (ops/ntxent.py).

Port of molclr_tpu/losses and of `resolve_ntxent` (molclr_tpu/parallel/
dp.py). The implementation names are the JAX package's, so one YAML serves
both packages: 'xla' is the closed form, 'pallas' the kernel (K2f/K2b,
CUDA on the card), 'auto' the kernel for CUDA tensors at a global 2B >=
4096 and the closed form otherwise.
"""

from __future__ import annotations

from molclr_tpu_torch.losses.nt_xent import nt_xent_loss
from molclr_tpu_torch.ops.ntxent import nt_xent_kernel

# 2B from which 'auto' takes the kernel (the JAX package's crossover)
AUTO_KERNEL_MIN_2B = 4096


def resolve_ntxent(impl: str, world: int = 1):
    """The loss callable (zis, zjs, temperature, use_cosine, pair_mask, dp)
    for PretrainConfig.ntxent_impl. Under data parallelism (dp, a
    parallel.DPGroup of `world` ranks) the callable gathers every rank's
    pairs before the loss, and 'auto' judges the global 2B = 2 B world, as
    the JAX package's resolve_ntxent(impl, n_devices) does."""
    if impl == "xla":
        return nt_xent_loss
    if impl == "pallas":
        return nt_xent_kernel
    if impl != "auto":
        raise ValueError(f"unknown ntxent_impl {impl!r}")

    def auto_loss(zis, zjs, temperature=0.1, use_cosine=True,
                  pair_mask=None, dp=None):
        two_b = 2 * zis.shape[0] * (world if dp is not None else 1)
        loss = (nt_xent_kernel if (zis.device.type == "cuda"
                                   and two_b >= AUTO_KERNEL_MIN_2B)
                else nt_xent_loss)
        return loss(zis, zjs, temperature, use_cosine, pair_mask=pair_mask,
                    dp=dp)

    return auto_loss


__all__ = ["AUTO_KERNEL_MIN_2B", "nt_xent_kernel", "nt_xent_loss",
           "resolve_ntxent"]
