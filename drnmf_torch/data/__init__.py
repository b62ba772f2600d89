"""Data: the wav corpus -> STFT stacks -> padded tensors, the native wav
reader, and the synthetic corpus."""

from .batching import (get_mask_value, load_split, make_transform,
                       masked_seqs_to_frames, pad_axis_to_n,
                       reshape_and_pad_stacks)
from .dataset import AudioDataset, clip_x_to_y, compute_stfts
from .synthetic import make_synthetic_corpus, wsj0_like_lengths

__all__ = ["AudioDataset", "clip_x_to_y", "compute_stfts", "get_mask_value",
           "load_split", "make_synthetic_corpus", "make_transform",
           "masked_seqs_to_frames", "pad_axis_to_n", "reshape_and_pad_stacks",
           "wsj0_like_lengths"]
