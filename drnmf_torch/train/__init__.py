"""Checkpoints (training itself belongs to a later slice of the port)."""

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
