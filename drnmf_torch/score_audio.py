"""Score enhanced against reference wav lists, per SNR condition
(counterpart of ``scripts/score_audio.py``; the reference's
score_audio.sh:1-32 + score_audio.m entry point, without the MATLAB
subprocess): BSS-Eval SDR, SNR, SegSNR local/global, PESQ and STOI, on
the card unless ``--device cpu``.

Two modes:

    # explicit taskfiles (score_audio.m's signature)
    python -m drnmf_torch.score_audio --enh taskfile_enh.txt \\
        --ref taskfile_ref.txt --savefile scores.npz [--no-pesq]

    # a description's enhanced outputs by SNR condition (score_audio.sh)
    python -m drnmf_torch.score_audio --desc unfolded_snmf_<hash>_valid \\
        --ref taskfile_chime2_valid_clean.txt [--no-pesq]
"""

import argparse
import os
import sys

from .device import resolve_device
from .metrics.scoring import SCORE_LABELS, SNRS, score_taskfiles


def read_list(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--enh", help="taskfile of enhanced wavs")
    parser.add_argument("--ref", required=True,
                        help="taskfile of reference wavs")
    parser.add_argument("--desc", help="description: score the "
                        "'scaled'->'enhanced_<desc>' substitutions by SNR")
    parser.add_argument("--savefile", default=None)
    parser.add_argument("--no-pesq", action="store_true",
                        help="skip PESQ (on by default, like the reference "
                        "score_audio.m:225; its column is -1.0)")
    parser.add_argument("--rescore", action="store_true",
                        help="ignore cached score files")
    parser.add_argument("--no-align", action="store_true",
                        help="skip the P.862-style time alignment "
                        "(unbounded + per-utterance delay compensation, on "
                        "by default; the reference aligned only inside "
                        "PESQ, score_audio.m:225).  The constant-delay "
                        "guard still applies.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                        "asked)")
    args = parser.parse_args(argv)
    align = "guard" if args.no_align else "full"
    resolve_device(args.device)  # raises without CUDA unless --device cpu
    refs = read_list(args.ref)
    kwargs = dict(compute_pesq=not args.no_pesq, flag_rescore=args.rescore,
                  align=align, device=args.device)

    if args.desc:
        for snr in SNRS:
            refs_snr = [w for w in refs if f"/{snr}/" in w]
            if not refs_snr:
                continue
            enh_snr = [w.replace("scaled", f"enhanced_{args.desc}")
                       for w in refs_snr]
            missing = [w for w in enh_snr if not os.path.isfile(w)]
            if missing:
                parser.error(
                    f"{len(missing)} enhanced file(s) for description "
                    f"'{args.desc}' not found, e.g. {missing[0]}")
            if args.savefile:
                base, ext = os.path.splitext(args.savefile)
                savefile = f"{base}_{snr}{ext or '.npz'}"
            else:
                savefile = f"scores_{args.desc}_{snr}.npz"
            print(f"Scoring SNR {snr} ({len(refs_snr)} files) -> {savefile}")
            S, _ = score_taskfiles(enh_snr, refs_snr, savefile=savefile,
                                   **kwargs)
            for label, val in zip(SCORE_LABELS, S.mean(axis=0)):
                print(f"  mean {label}: {val:.3f}")
        return

    if not args.enh:
        parser.error("either --enh or --desc is required")
    enh = read_list(args.enh)
    if len(enh) != len(refs):
        parser.error(f"list length mismatch: {len(enh)} enhanced vs "
                     f"{len(refs)} reference files")
    S, _ = score_taskfiles(enh, refs, savefile=args.savefile, **kwargs)
    for label, val in zip(SCORE_LABELS, S.mean(axis=0)):
        print(f"mean {label}: {val:.3f}")


if __name__ == "__main__":
    main(sys.argv[1:])
