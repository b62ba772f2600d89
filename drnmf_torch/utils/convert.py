"""Import trained weights from the reference's Keras 2.0.4 HDF5 checkpoints
(counterpart of ``drnmf_tpu/utils/convert.py``).

Two modules are named ``convert``: this one reads the reference's Keras
files; ``drnmf_torch/convert.py`` carries the JAX package's parameters
into the port (and initialises a model).  The functions here return
name -> numpy dicts, the layout of the ``.npz`` checkpoints either package
reads (``train/checkpoint.py``); ``python -m
drnmf_torch.import_reference_weights`` writes one.  ``h5py`` is imported
where a file is read, so the port imports without it.

Migration tool: a user of the reference (enhance.py ModelCheckpoint files,
``models/model_<type>_<hash>.hdf5``) can load their trained DR-NMF or LSTM
weights directly into the port's parameter dicts.

Keras 2.0.4 ``save_weights`` layout: root attr ``layer_names``; one group
per layer with attr ``weight_names`` listing dataset paths.  Weight names of
interest (built in custom_layers.py / enhance.py):

* SimpleDeepRNN alt params added as ``<layer>_<key>``
  (custom_layers.py:219-228): log_D / log_D_<k>, log_U1, log_Uk,
  log_alph / log_alph_<k>, log_lam1 / log_lam1_<k>, log_h0 -- stored exactly
  as the port's alt-param entries (same shapes, log domain).
* head layers named ``clean_est`` / ``noise_est`` (enhance.py:283,292):
  bias-free DenseNonNegW kernels of shape (r, F), log-domain == our
  ``log_W_clean`` / ``log_W_noise``.
* LSTM baseline: per-layer ``kernel`` (input, 4n), ``recurrent_kernel``
  (n, 4n), ``bias`` (4n,) in Keras i,f,c,o gate order == our
  ``lstm<k>_Wx/Wh/b``; final TimeDistributed Dense ``kernel``/``bias`` ==
  ``dense_W``/``dense_b``.
"""

import re

import numpy as np

_ALT_KEYS = ("log_D", "log_U1", "log_Uk", "log_alph", "log_lam1", "log_h0")


def _iter_keras_weights(h5):
    """Yield (layer_name, weight_name, np.ndarray) triples."""
    layer_names = [
        n.decode() if isinstance(n, bytes) else n
        for n in h5.attrs["layer_names"]
    ]
    for layer in layer_names:
        grp = h5[layer]
        weight_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in grp.attrs.get("weight_names", [])
        ]
        for wn in weight_names:
            yield layer, wn, np.asarray(grp[wn])


def _base_name(weight_name):
    """'simple_deep_rnn_1/simple_deep_rnn_1_log_D_0:0' -> trailing
    identifier without layer prefix or ':0'."""
    name = weight_name.split("/")[-1]
    return name.split(":")[0]


def import_drnmf_keras_weights(h5path):
    """Reference DR-NMF HDF5 -> the port's alt-param dict."""
    import h5py

    params = {}
    with h5py.File(h5path, "r") as h5:
        for layer, wn, value in _iter_keras_weights(h5):
            base = _base_name(wn)
            if layer == "clean_est" or "clean_est" in wn:
                params["log_W_clean"] = value
                continue
            if layer == "noise_est" or "noise_est" in wn:
                params["log_W_noise"] = value
                continue
            for key in _ALT_KEYS:
                m = re.search(rf"{key}(_\d+)?$", base)
                if m:
                    suffix = m.group(1) or ""
                    params[key + suffix] = value
                    break
    if "log_W_clean" not in params or not any(
        k.startswith("log_D") for k in params
    ):
        raise ValueError(
            f"{h5path} does not look like a reference DR-NMF checkpoint "
            f"(found keys: {sorted(params)})"
        )
    return params


def validate_drnmf_import(params, config):
    """Shape-check an imported DR-NMF parameter dict against a DRNMFConfig,
    catching the silent failure modes of a layout mismatch: transposed head
    kernels ((F, r) vs (r, F)), tied-vs-untied key sets, and wrong
    hidden/input dimensions.  Raises ValueError naming the offender."""
    f, r, n2r = config.input_dim, config.r, config.hidden_dim
    expect = {
        "log_U1": (n2r, n2r), "log_Uk": (n2r, n2r),
        "log_W_clean": (r, f), "log_W_noise": (r, f),
    }
    if config.nonnegative:
        expect["log_h0"] = (n2r,)
    else:
        expect["h0"] = (n2r,)  # plain trainable h0 (init_drnmf_params)
    alph_shape = (n2r,) if config.untie_alph else ()
    for base, shape in (("log_D", (f, n2r)), ("log_alph", alph_shape),
                        ("log_lam1", ())):
        names = ([f"{base}_{k}" for k in range(config.K_layers)]
                 if base in config.params_untied else [base])
        for name in names:
            expect[name] = shape
    missing = sorted(set(expect) - set(params))
    extra = sorted(set(params) - set(expect))
    if missing or extra:
        raise ValueError(
            f"imported DR-NMF params do not match the config's key set "
            f"(missing: {missing}, unexpected: {extra}) -- check K_layers/"
            f"params_untied against the reference run's YAML")
    for name, shape in expect.items():
        got = tuple(np.shape(params[name]))
        if got != tuple(shape):
            hint = (" (transposed? the reference stores head kernels as "
                    "(r, F) and log_D as (F, 2r))"
                    if got == tuple(shape)[::-1] and len(shape) == 2 else "")
            raise ValueError(
                f"imported param '{name}' has shape {got}, expected "
                f"{tuple(shape)}{hint}")
    return params


def validate_lstm_import(params, config):
    """Shape-check an imported LSTM parameter dict against an LSTMConfig
    (same failure modes as validate_drnmf_import)."""
    f, n = config.input_dim, config.hidden_dim
    expect = {"dense_W": (n, config.output_dim),
              "dense_b": (config.output_dim,)}
    for k in range(config.K_layers):
        inp = f if k == 0 else n
        expect[f"lstm{k}_Wx"] = (inp, 4 * n)
        expect[f"lstm{k}_Wh"] = (n, 4 * n)
        expect[f"lstm{k}_b"] = (4 * n,)
    missing = sorted(set(expect) - set(params))
    extra = sorted(set(params) - set(expect))
    if missing or extra:
        raise ValueError(
            f"imported LSTM params do not match the config's key set "
            f"(missing: {missing}, unexpected: {extra}) -- check K_layers/"
            f"hidden_dim against the reference run's YAML")
    for name, shape in expect.items():
        got = tuple(np.shape(params[name]))
        if got != shape:
            hint = (" (transposed?)" if got == shape[::-1]
                    and len(shape) == 2 else "")
            raise ValueError(
                f"imported param '{name}' has shape {got}, expected "
                f"{shape}{hint}")
    return params


def import_lstm_keras_weights(h5path):
    """Reference LSTM-baseline HDF5 -> the port's parameter dict."""
    import h5py

    params = {}
    lstm_idx = 0
    with h5py.File(h5path, "r") as h5:
        for layer, wn, value in _iter_keras_weights(h5):
            base = _base_name(wn)
            if "lstm" in layer:
                # Keras lists kernel, recurrent_kernel, bias per layer
                if base.endswith("recurrent_kernel") or "recurrent" in base:
                    params[f"lstm{lstm_idx}_Wh"] = value
                elif base.endswith("kernel"):
                    params[f"lstm{lstm_idx}_Wx"] = value
                elif base.endswith("bias"):
                    params[f"lstm{lstm_idx}_b"] = value
                    lstm_idx += 1
            elif base.endswith("kernel"):
                params["dense_W"] = value
            elif base.endswith("bias"):
                params["dense_b"] = value
    if "dense_W" not in params or "lstm0_Wx" not in params:
        raise ValueError(
            f"{h5path} does not look like a reference LSTM checkpoint "
            f"(found keys: {sorted(params)})"
        )
    return params
