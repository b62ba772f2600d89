"""Helpers around the models: the hash-keyed dictionary cache (and, as
submodules, ``profiling`` and ``memplan``)."""

from .cache import load_snmf, save_snmf, snmf_cache_path

__all__ = ["load_snmf", "save_snmf", "snmf_cache_path"]
