"""Clean-room chemistry layer (copied from molclr_tpu.chem): SMILES
parsing, canonical SMILES, Murcko scaffolds and BRICS decomposition."""

from molclr_tpu_torch.chem.mol import (
    Atom,
    Bond,
    BondDir,
    BondType,
    Chirality,
    Mol,
)
from molclr_tpu_torch.chem.smiles import SmilesError, parse_smiles

__all__ = ["Atom", "Bond", "BondDir", "BondType", "Chirality", "Mol",
           "SmilesError", "parse_smiles"]
