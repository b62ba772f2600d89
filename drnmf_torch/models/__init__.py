"""DR-NMF model (inference side) and the SNMF enhancer."""

from .drnmf import (DRNMF, DRNMFConfig, FoldedU, drnmf_forward,
                    ensure_fold_valid, fold_structure_holds, make_scan,
                    u_is_foldable)
from .snmf_enhancer import snmf_infer_irm

__all__ = ["DRNMF", "DRNMFConfig", "FoldedU", "drnmf_forward",
           "ensure_fold_valid", "fold_structure_holds", "make_scan",
           "snmf_infer_irm",
           "u_is_foldable"]
