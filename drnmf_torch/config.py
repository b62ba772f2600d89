"""Model YAML -> ``DRNMFConfig`` and ``SNMFParams``, the artifact hash, YAML
I/O and the experiment folder (counterparts of the JAX package's
``pipeline.drnmf_config_from_params``, the ``SNMFParams`` built in
``pipeline._dict_from_config`` and ``utils.config``).

Keys that name knobs of the TPU build (``use_pallas``, ``remat``,
``remat_policy``, ``scan_unroll``, ``batched_grad``, ...) are accepted and
ignored, so the reference's model YAMLs load as they are."""

import hashlib
import json
import os

import numpy as np
import yaml

from .models.drnmf import DRNMFConfig
from .ops.snmf import SNMFParams


class _NumpyEncoder(json.JSONEncoder):
    """Numpy scalars and arrays as JSON, like the reference's ``MyEncoder``."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def config_hash(config: dict, exclude=()) -> str:
    """md5 of the sorted JSON of ``config`` without the keys ``exclude``:
    the name of every artifact (enhance.py:60-78 of the reference), equal
    to the JAX package's for the same config."""
    cfg = {k: v for k, v in config.items() if k not in exclude}
    return hashlib.md5(
        json.dumps(cfg, sort_keys=True, cls=_NumpyEncoder).encode()
    ).hexdigest()


def load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f.read())


def dump_yaml(obj, path):
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def ensure_experiment_dirs(folder_exp):
    """Create the experiment folder layout (enhance.py:709-713 of the
    reference): ``configs``, ``history``, ``models``, ``scores``."""
    for sub in ("configs", "history", "models", "scores"):
        os.makedirs(os.path.join(folder_exp, sub), exist_ok=True)
    return folder_exp


def drnmf_config_from_params(params_model: dict, input_dim: int,
                             mask_value: float = -1.0) -> DRNMFConfig:
    """The single YAML-key -> config mapping: a missing key here would run
    a different architecture than training did."""
    return DRNMFConfig(
        input_dim=input_dim,
        r=int(params_model["r"]),
        output_dim=input_dim,
        K_layers=int(params_model["K_layers"]),
        alph=float(params_model["alph"]),
        lam1=float(params_model["lam1"]),
        mask_value=mask_value,
        untie_alph=bool(params_model.get("untie_alph", False)),
        params_untied=tuple(params_model.get("params_untied", [])),
        params_trainable=tuple(params_model.get("params_trainable", [])),
        transform_before_irm=params_model.get("transform_before_irm"),
        activation=params_model.get("activation", "relu"),
        connect_input_to_layers=bool(
            params_model.get("connect_input_to_layers", True)),
        nonnegative=bool(params_model.get("nonnegative", True)),
        return_all_hidden=bool(params_model.get("return_all_hidden", False)),
        dropout_W=float(params_model.get("dropout_W", 0.0)),
        dropout_U=float(params_model.get("dropout_U", 0.0)),
        matmul_precision=params_model.get("matmul_precision", "default"),
        fold_frozen_U=bool(params_model.get("fold_frozen_U", True)),
        factored_S=bool(params_model.get("factored_S", True)),
    )


def snmf_params_from_config(params_model: dict) -> SNMFParams:
    """The dictionary stage's settings from a model YAML, with the
    pipeline's defaults (ED cost, sparsity from ``lam1``, 1000 iterations,
    conv_eps 1e-4, seed 2016)."""
    return SNMFParams(
        r=int(params_model["r"]),
        cf=params_model.get("cf", "ed"),
        sparsity=float(params_model.get(
            "lam1", params_model.get("sparsity", 1.0))),
        max_iter=int(params_model.get("snmf_max_iter", 1000)),
        conv_eps=float(params_model.get("snmf_conv_eps", 1e-4)),
        random_seed=int(params_model.get("random_seed", 2016)),
    )
