"""MoleculeNet fine-tune task registry.

Mirrors the reference's hardcoded task table (ref finetune.py:401-491) as
data: task type, CSV path (relative to a data root), target columns, loss and
metric selection (ref finetune.py:71-77,300-315), and the qm9 unit
conversions (ref dataset/dataset_test.py:120-123).

Copied from molclr_tpu/data/tasks.py with its imports
rewritten to this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class TaskSpec:
    name: str
    task: str                    # 'classification' | 'regression'
    data_path: str               # relative CSV path under the data root
    targets: tuple[str, ...]
    loss: str                    # 'ce' | 'mse' | 'l1'
    metric: str                  # 'roc_auc' | 'rmse' | 'mae'
    normalize_labels: bool = False  # z-score labels (qm7/qm9, finetune.py:136-142)
    add_hs: bool = True          # fine-tune datasets AddHs (dataset_test.py:127)


_QM9_EV_TARGETS = ("homo", "lumo", "gap", "zpve", "u0")
HARTREE_TO_EV = 27.211386  # ref dataset/dataset_test.py:120-123


TASKS: dict[str, TaskSpec] = {
    t.name: t for t in [
        TaskSpec("BBBP", "classification", "bbbp/BBBP.csv", ("p_np",),
                 "ce", "roc_auc"),
        TaskSpec("Tox21", "classification", "tox21/tox21.csv", (
            "NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER",
            "NR-ER-LBD", "NR-PPAR-gamma", "SR-ARE", "SR-ATAD5", "SR-HSE",
            "SR-MMP", "SR-p53"), "ce", "roc_auc"),
        TaskSpec("ClinTox", "classification", "clintox/clintox.csv",
                 ("CT_TOX", "FDA_APPROVED"), "ce", "roc_auc"),
        TaskSpec("HIV", "classification", "hiv/HIV.csv", ("HIV_active",),
                 "ce", "roc_auc"),
        TaskSpec("BACE", "classification", "bace/bace.csv", ("Class",),
                 "ce", "roc_auc"),
        TaskSpec("SIDER", "classification", "sider/sider.csv", (
            "Hepatobiliary disorders", "Metabolism and nutrition disorders",
            "Product issues", "Eye disorders", "Investigations",
            "Musculoskeletal and connective tissue disorders",
            "Gastrointestinal disorders", "Social circumstances",
            "Immune system disorders",
            "Reproductive system and breast disorders",
            "Neoplasms benign, malignant and unspecified (incl cysts and polyps)",
            "General disorders and administration site conditions",
            "Endocrine disorders", "Surgical and medical procedures",
            "Vascular disorders", "Blood and lymphatic system disorders",
            "Skin and subcutaneous tissue disorders",
            "Congenital, familial and genetic disorders",
            "Infections and infestations",
            "Respiratory, thoracic and mediastinal disorders",
            "Psychiatric disorders", "Renal and urinary disorders",
            "Pregnancy, puerperium and perinatal conditions",
            "Ear and labyrinth disorders", "Cardiac disorders",
            "Nervous system disorders",
            "Injury, poisoning and procedural complications"),
            "ce", "roc_auc"),
        TaskSpec("MUV", "classification", "muv/muv.csv", (
            "MUV-692", "MUV-689", "MUV-846", "MUV-859", "MUV-644",
            "MUV-548", "MUV-852", "MUV-600", "MUV-810", "MUV-712",
            "MUV-737", "MUV-858", "MUV-713", "MUV-733", "MUV-652",
            "MUV-466", "MUV-832"), "ce", "roc_auc"),
        TaskSpec("FreeSolv", "regression", "freesolv/freesolv.csv",
                 ("expt",), "mse", "rmse"),
        TaskSpec("ESOL", "regression", "esol/esol.csv",
                 ("measured log solubility in mols per litre",),
                 "mse", "rmse"),
        TaskSpec("Lipo", "regression", "lipophilicity/Lipophilicity.csv",
                 ("exp",), "mse", "rmse"),
        TaskSpec("qm7", "regression", "qm7/qm7.csv", ("u0_atom",),
                 "l1", "mae", normalize_labels=True),
        TaskSpec("qm8", "regression", "qm8/qm8.csv", (
            "E1-CC2", "E2-CC2", "f1-CC2", "f2-CC2", "E1-PBE0", "E2-PBE0",
            "f1-PBE0", "f2-PBE0", "E1-CAM", "E2-CAM", "f1-CAM", "f2-CAM"),
            "l1", "mae"),
        TaskSpec("qm9", "regression", "qm9/qm9.csv", (
            "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "cv"),
            "l1", "mae", normalize_labels=True),
    ]
}


def qm9_label_scale(target: str) -> float:
    """Hartree -> eV-style conversion for selected qm9 targets
    (ref dataset/dataset_test.py:120-123,163)."""
    return HARTREE_TO_EV if target in _QM9_EV_TARGETS else 1.0
