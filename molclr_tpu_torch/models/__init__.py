"""GIN / GCN encoders (PyTorch) with the reference's state-dict schema, and
the Graphormer fine-tuning network."""

from molclr_tpu_torch.models.graphormer import GraphormerNet
from molclr_tpu_torch.models.layers import GCNConv, GINEConv, MaskedBatchNorm
from molclr_tpu_torch.models.nets import (
    Encoder,
    FineTuneNet,
    LinkFineTuneNet,
    MolCLRNet,
    MotifFineTuneNet,
)

__all__ = ["Encoder", "FineTuneNet", "GCNConv", "GINEConv", "GraphormerNet",
           "LinkFineTuneNet", "MaskedBatchNorm", "MolCLRNet",
           "MotifFineTuneNet"]
