"""Helpers around the models: the hash-keyed dictionary cache."""

from .cache import load_snmf, save_snmf, snmf_cache_path

__all__ = ["load_snmf", "save_snmf", "snmf_cache_path"]
