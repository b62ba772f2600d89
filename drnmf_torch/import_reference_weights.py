"""Convert a reference Keras checkpoint to the ``.npz`` checkpoint both
packages read (counterpart of ``scripts/import_reference_weights.py``).

Migration path for users of the reference: take the HDF5 weights its
ModelCheckpoint wrote (models/model_<type>_<hash>.hdf5) and write a
checkpoint the port's pipeline, ``enhance_wav`` and ``serve`` load as it
is.  The model family comes from the file name, as the reference's
enhance.py picks it ('unfolded_snmf' before 'snmf' before 'lstm').  Needs ``h5py``.

Usage:
    python -m drnmf_torch.import_reference_weights \\
        model_unfolded_snmf_<hash>.hdf5 [-o model_unfolded_snmf_<hash>.npz] \\
        [-c params_unfolded_snmf_<hash>.yaml]
"""

import argparse
import os
import sys

from .train.checkpoint import save_checkpoint
from .utils.convert import (import_drnmf_keras_weights,
                            import_lstm_keras_weights)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("h5file", help="reference Keras HDF5 weights")
    parser.add_argument("-o", "--out", default=None,
                        help="output .npz (default: same name, .npz)")
    parser.add_argument("-c", "--config", default=None,
                        help="model YAML of the reference run; if given, "
                        "imported shapes are validated against it "
                        "(catches transposed/mismatched layouts)")
    parser.add_argument("--n-fft", type=int, default=512)
    args = parser.parse_args(argv)

    if not os.path.isfile(args.h5file):
        parser.error(f"file not found: {args.h5file}")
    name = os.path.basename(args.h5file)
    if "unfolded_snmf" in name:
        params = import_drnmf_keras_weights(args.h5file)
    elif "lstm" in name:
        params = import_lstm_keras_weights(args.h5file)
    else:
        parser.error(
            f"cannot infer model type from filename '{name}' "
            "(expected an 'unfolded_snmf' or 'lstm' substring)")

    if args.config:
        from .config import drnmf_config_from_params, load_yaml
        from .utils.convert import validate_drnmf_import, validate_lstm_import

        cfg = load_yaml(args.config)
        f_bins = args.n_fft // 2 + 1
        if "unfolded_snmf" in name:
            validate_drnmf_import(params,
                                  drnmf_config_from_params(cfg, f_bins))
        else:
            from .models.lstm import LSTMConfig

            validate_lstm_import(params, LSTMConfig(
                input_dim=f_bins, hidden_dim=int(cfg["hidden_dim"]),
                output_dim=f_bins, K_layers=int(cfg["K_layers"])))
        print("shape validation against config: OK")

    out = args.out or os.path.splitext(args.h5file)[0] + ".npz"
    save_checkpoint(out, params)
    print(f"{args.h5file} -> {out} ({len(params)} tensors)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
