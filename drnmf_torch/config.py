"""Model YAML -> ``DRNMFConfig`` (counterpart of the JAX package's
``pipeline.drnmf_config_from_params`` and ``utils.config.load_yaml``).

Keys that name knobs of the TPU build (``use_pallas``, ``remat``,
``remat_policy``, ``scan_unroll``, ``batched_grad``, ...) are accepted and
ignored, so the reference's model YAMLs load as they are."""

import yaml

from .models.drnmf import DRNMFConfig


def load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f.read())


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
