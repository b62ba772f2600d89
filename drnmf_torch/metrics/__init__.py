"""The scoring metrics in PyTorch (counterpart of ``drnmf_tpu/metrics``):
SDR, SNR, segmental SNR, PESQ and STOI of enhanced against clean wavs,
with the time-alignment guard, one file at a time or batched on the device
(``engine.score_all_packed``), and the cached scoring of taskfiles."""

from .align import align_pair, estimate_delay, split_utterances
from .bss_eval import bss_eval_sdr
from .snr import snr, snrseg
from .stoi import stoi
from .pesq import pesq_16k
from .scoring import compute_scores, score_taskfiles, SCORE_LABELS

__all__ = [
    "align_pair",
    "estimate_delay",
    "split_utterances",
    "bss_eval_sdr",
    "snr",
    "snrseg",
    "stoi",
    "pesq_16k",
    "compute_scores",
    "score_taskfiles",
    "SCORE_LABELS",
]
