"""GIN / GCN encoders (PyTorch) with the reference's state-dict schema."""

from molclr_tpu_torch.models.layers import GCNConv, GINEConv, MaskedBatchNorm
from molclr_tpu_torch.models.nets import (
    Encoder,
    FineTuneNet,
    LinkFineTuneNet,
    MolCLRNet,
    MotifFineTuneNet,
)

__all__ = ["Encoder", "FineTuneNet", "GCNConv", "GINEConv",
           "LinkFineTuneNet", "MaskedBatchNorm", "MolCLRNet",
           "MotifFineTuneNet"]
