"""Checkpoints and the SNMF dictionary recipe (training the DR-NMF model
itself belongs to a later slice of the port)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .snmf_recipe import train_snmf

__all__ = ["load_checkpoint", "save_checkpoint", "train_snmf"]
