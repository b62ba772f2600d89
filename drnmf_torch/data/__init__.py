"""Data glue between the model's tensors and the dictionary stage."""

from .batching import masked_seqs_to_frames

__all__ = ["masked_seqs_to_frames"]
