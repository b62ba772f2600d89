"""Enhance wav files with a trained DR-NMF checkpoint.

Direct inference: a model config YAML + an ``.npz`` checkpoint (as either
package writes it) + wavs in, enhanced wavs out, through
:func:`drnmf_torch.enhance.enhance_signals`.

Usage:
    python -m drnmf_torch.enhance_wav -c params_unfolded_snmf_<hash>.yaml \\
        -m model_unfolded_snmf_<hash>.npz noisy.wav -o enhanced.wav
    python -m drnmf_torch.enhance_wav -c cfg.yaml -m ckpt.npz \\
        --taskfile noisy_list.txt -o out_dir/
    # add --device cpu to run without a card
"""

import argparse
import os

from .config import drnmf_config_from_params, load_yaml
from .convert import params_from_numpy
from .device import resolve_device
from .dsp.wav import wavread_fs, wavwrite
from .enhance import enhance_signals, stage_clock
from .models.drnmf import ensure_fold_valid
from .train.checkpoint import load_checkpoint


ENHANCE_STAGES = ("pad_and_copy_in", "stft", "mask", "istft",
                  "copy_out_and_trim")


def _report(stages, audio_seconds, device):
    lines = [f"device: {device}"]
    lines += [f"  {name}: {secs:.3f}s" for name, secs in stages.items()]
    enhance = sum(stages[name] for name in ENHANCE_STAGES)
    lines.append(f"  enhance: {enhance:.3f}s "
                 f"({audio_seconds / enhance:.1f}x real-time)")
    lines.append(f"  total: {sum(stages.values()):.3f}s")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("wavs", nargs="*", help="input wav files")
    parser.add_argument("-c", "--config", required=True, help="model YAML")
    parser.add_argument("-m", "--model", required=True, help="checkpoint .npz")
    parser.add_argument("--taskfile", help="file listing input wavs")
    parser.add_argument("-o", "--out", required=True,
                        help="output wav (single input) or directory")
    parser.add_argument("--n-fft", type=int, default=512)
    parser.add_argument("--hop", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    inputs = list(args.wavs)
    if args.taskfile:
        with open(args.taskfile) as f:
            inputs += [line.strip() for line in f if line.strip()]
    if not inputs:
        parser.error("no input wavs (positional args or --taskfile)")
    missing = [p for p in inputs if not os.path.isfile(p)]
    if missing:
        parser.error(f"input wav not found: {missing[0]}")
    if len(inputs) > 1:
        os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)

    config = drnmf_config_from_params(load_yaml(args.config),
                                      args.n_fft // 2 + 1)
    try:
        params, _ = load_checkpoint(args.model)
    except FileNotFoundError:
        parser.error(f"checkpoint not found: {args.model}")
    config = ensure_fold_valid(config, params)

    stages = {}
    lap = stage_clock(stages, device)
    params = params_from_numpy(params, device)
    lap("load")
    sigs, rates = [], []
    for path in inputs:
        x, fs = wavread_fs(path)
        sigs.append(x[0])
        rates.append(fs)
    lap("read")
    outs = enhance_signals(params, config, sigs, args.n_fft, args.hop,
                           batch_size=args.batch_size, device=device, lap=lap)
    for path, fs, y in zip(inputs, rates, outs):
        if len(inputs) == 1 and not os.path.isdir(args.out):
            out_path = args.out
        else:
            out_path = os.path.join(args.out, os.path.basename(path))
        wavwrite(out_path, fs, y[None])
        print(f"{path} -> {out_path}")
    lap("write")
    print(_report(stages, sum(len(s) for s in sigs) / rates[0], device))
    return outs


if __name__ == "__main__":
    main()
