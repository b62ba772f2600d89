"""Per-rank memory of a DR-NMF fit's parameters and Adam moments, in
closed form (counterpart of ``drnmf_tpu/utils/memplan.py``), for one
H100's 80 GB.

Parameter shapes follow ``convert.init_drnmf_params``; Adam keeps two
moments of each trainable tensor (``models.drnmf_trainable_mask``; frozen
tensors have none); under FSDP each rank holds 1/dp of every tensor the
rule of ``parallel.mesh.fsdp_shard_dim`` shards, its moments alike
(``train.loop`` places both by that rule).  What a fit holds besides
(activations, the recurrence's residuals, the splits) is not counted.

Example: the flagship (K=5, untied D and alph, 2r=2000, F=257) holds
44.3 MB of parameters and 24.7 MB of moments replicated, 32 MB of it the
two frozen (2r, 2r) U tensors; at 2r=100k those two alone take 80 GB,
one card's memory, and train only sharded.

Usage:
    python -m drnmf_torch.utils.memplan -c params_unfolded_snmf.yaml \\
        --input-dim 257 --dp 2 --fsdp
"""

import numpy as np

from ..parallel.mesh import fsdp_shard_dim

CARD_BYTES = 80 * 10**9  # one H100


def drnmf_param_shapes(config) -> dict:
    """Parameter name -> shape, as ``init_drnmf_params`` builds them,
    without making any array."""
    n2r = config.hidden_dim
    f = config.input_dim
    shapes = {
        "log_U1": (n2r, n2r),
        "log_Uk": (n2r, n2r),
        "log_W_clean": (config.r, f),
        "log_W_noise": (n2r - config.r, f),
    }
    shapes["log_h0" if config.nonnegative else "h0"] = (n2r,)
    base = {
        "log_D": (f, n2r),
        "log_alph": (n2r,) if config.untie_alph else (),
        "log_lam1": (),
    }
    for name, shape in base.items():
        if name in config.params_untied:
            for k in range(config.K_layers):
                shapes[f"{name}_{k}"] = shape
        else:
            shapes[name] = shape
    return shapes


def _local_elems(shape, n_dp, min_elems):
    """Elements of a tensor one rank holds under the FSDP rule."""
    total = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if fsdp_shard_dim(shape, n_dp, min_elems) is None:
        return total
    return total // n_dp


def plan_memory(config, n_dp=1, fsdp=False, min_elems=1 << 16,
                dtype_bytes=4):
    """Bytes one rank holds: ``params``, ``opt_state`` (two Adam moments of
    each trainable tensor), ``total``, ``per_tensor`` detail, the
    ``layout`` and ``fits`` (the total within one card's 80 GB).
    ``fsdp=False`` is the replicated layout (every rank holds everything)."""
    from ..models.drnmf import drnmf_trainable_mask

    shapes = drnmf_param_shapes(config)
    trainable = drnmf_trainable_mask(config, shapes)
    detail = {}
    p_bytes = o_bytes = 0
    for name, shape in shapes.items():
        local = (_local_elems(shape, n_dp, min_elems) if fsdp
                 else int(np.prod(shape, dtype=np.int64)) if shape else 1)
        pb = local * dtype_bytes
        ob = 2 * pb if trainable[name] else 0
        detail[name] = {"shape": shape, "param_bytes": pb,
                        "moment_bytes": ob, "trainable": trainable[name]}
        p_bytes += pb
        o_bytes += ob
    return {"params": p_bytes, "opt_state": o_bytes,
            "total": p_bytes + o_bytes, "per_tensor": detail,
            "layout": "fsdp" if fsdp else "replicated", "n_dp": n_dp,
            "fits": p_bytes + o_bytes <= CARD_BYTES}


def _fmt(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024 or unit == "TB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b} B"
        b /= 1024


def main(argv=None):
    import argparse

    from ..config import drnmf_config_from_params, load_yaml

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--config", required=True,
                    help="model YAML (params_unfolded_snmf_*.yaml)")
    ap.add_argument("--input-dim", type=int, default=257,
                    help="F = n_fft//2 + 1 (default 257: N=512)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    args = ap.parse_args(argv)

    config = drnmf_config_from_params(load_yaml(args.config), args.input_dim)
    plan = plan_memory(config, n_dp=args.dp, fsdp=args.fsdp)
    print(f"layout={plan['layout']} dp={plan['n_dp']} "
          f"(K={config.K_layers}, 2r={config.hidden_dim}, "
          f"F={config.input_dim})")
    for name, d in sorted(plan["per_tensor"].items(),
                          key=lambda kv: -kv[1]["param_bytes"]):
        t = "train" if d["trainable"] else "frozen"
        print(f"  {name:16s} {str(d['shape']):16s} {t}  "
              f"param {_fmt(d['param_bytes']):>10s}  "
              f"adam {_fmt(d['moment_bytes']):>10s}")
    print(f"per-rank params    : {_fmt(plan['params'])}")
    print(f"per-rank opt state : {_fmt(plan['opt_state'])}")
    print(f"per-rank total     : {_fmt(plan['total'])} "
          f"({'fits' if plan['fits'] else 'does not fit'} one 80 GB card)")


if __name__ == "__main__":
    main()
