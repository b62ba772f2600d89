"""DR-NMF model (inference and training sides), the LSTM baseline and the
SNMF enhancer."""

from .batched_grad import (batched_grad_residual_bytes, scan_factored_train,
                           scan_factored_train_reference)
from .drnmf import (DRNMF, DRNMFConfig, FoldedU, drnmf_forward,
                    drnmf_trainable_mask, dropout_masks, ensure_fold_valid,
                    fold_structure_holds, make_scan, u_is_foldable)
from .lstm import LSTM, LSTMConfig, init_lstm_params, lstm_forward
from .snmf_enhancer import snmf_infer_irm

__all__ = ["DRNMF", "DRNMFConfig", "FoldedU", "LSTM", "LSTMConfig",
           "batched_grad_residual_bytes", "drnmf_forward",
           "drnmf_trainable_mask", "dropout_masks", "ensure_fold_valid",
           "fold_structure_holds", "init_lstm_params", "lstm_forward",
           "make_scan",
           "scan_factored_train", "scan_factored_train_reference",
           "snmf_infer_irm", "u_is_foldable"]
