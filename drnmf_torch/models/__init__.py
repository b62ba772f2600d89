"""DR-NMF model (inference side)."""

from .drnmf import (DRNMF, DRNMFConfig, FoldedU, drnmf_forward,
                    ensure_fold_valid, fold_structure_holds, u_is_foldable)

__all__ = ["DRNMF", "DRNMFConfig", "FoldedU", "drnmf_forward",
           "ensure_fold_valid", "fold_structure_holds", "u_is_foldable"]
