"""Helpers around the models: the config hash and YAML I/O (kept in
``drnmf_torch.config``), the hash-keyed dictionary cache, tracing and
stage timing (``profiling``), and, as submodules, ``memplan`` and the Keras
weight import (``convert``)."""

from ..config import config_hash, dump_yaml, ensure_experiment_dirs, load_yaml
from .cache import load_snmf, save_snmf, snmf_cache_path
from .profiling import StageTimer, device_sync, trace

__all__ = ["config_hash", "load_yaml", "dump_yaml", "ensure_experiment_dirs",
           "snmf_cache_path", "save_snmf", "load_snmf", "StageTimer",
           "trace", "device_sync"]
