"""The experiment pipeline (counterpart of ``drnmf_tpu/pipeline.py``; the
reference driver's main() flow, enhance.py:459-1437, as functions).

Stages: the data (cached tensors) -> the SNMF dictionary (cached) -> the
model, built and trained (the best checkpoint cached) -> full-length mask
prediction -> audio reconstruction.  Every artifact is named by the md5
hash of its config, the same name as the JAX package's, so reruns reuse
them and resume from them.

Each ``run_*`` runs on ``device`` (the card unless ``device="cpu"``;
raises where CUDA was asked for and is absent) and enhances each split of
``splits``: its wavs go to the 'scaled' -> 'enhanced_<model>_<hash>_<split>'
path of each clean file.  Scoring (``score_split``) waits for ROADMAP.md
queue A, item 8: until then ``flag_score=True`` raises
``NotImplementedError`` before any work, and ``flag_score=False`` enhances
without scoring (where the JAX package's ``flag_score=False`` skips the
enhancement as well; ``splits=()`` trains only).  The mesh, FSDP and tp
arguments wait for item 10.  Each ``run_*`` returns its results with a
:class:`StageTimer` (``results["timer"]``): ``dictionary`` and ``train``,
then ``load_tensors``, ``predict_irm`` and ``reconstruct`` for each split,
named ``<stage>:<split>``; its real-time factor is each split's audio over
the seconds of its prediction and reconstruction.
"""

import os
import pickle

import numpy as np
import torch

from .config import (config_hash, drnmf_config_from_params, dump_yaml,
                     ensure_experiment_dirs, snmf_params_from_config)
from .convert import init_drnmf_params, params_from_numpy
from .data import (AudioDataset, get_mask_value, load_split,
                   masked_seqs_to_frames)
from .device import resolve_device
from .dsp.stft import istft
from .dsp.wav import wavwrite
from .models import (LSTMConfig, drnmf_forward, drnmf_trainable_mask,
                     ensure_fold_valid, init_lstm_params, lstm_forward,
                     snmf_infer_irm)
from .train import (TrainConfig, load_checkpoint, masked_mse_signal_approx,
                    snmf_pretrain_loss, train_model, train_snmf,
                    train_state_incomplete)
from .utils.cache import load_snmf, snmf_cache_path
from .utils.profiling import StageTimer

SCORING_NOT_PORTED = (
    "scoring is not ported yet (ROADMAP.md, queue A, item 8): enhance "
    "without it (flag_score=False; --no-score on the command line)")


def dataset_audio_seconds(dataset, fs=None):
    """Audio duration from the frame counts (frames * hop / fs)."""
    hop = int(dataset.params_stft["hop"])
    n_frames = int(np.sum(dataset.fidx[:, 1] - dataset.fidx[:, 0]))
    return n_frames * hop / (dataset.fs if fs is None else fs)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def build_datasets(params_data, splits=("train", "valid", "test"),
                   device="cuda"):
    """An ``AudioDataset`` a split (enhance.py:740-743)."""
    out = {}
    for split in splits:
        out[split] = AudioDataset(
            params_data[f"taskfile_x_{split}"],
            params_data[f"taskfile_y_{split}"],
            datafile=params_data.get(f"datafile_{split}"),
            params_stft=params_data["params_stft"],
            downsample=(params_data.get("downsample", 1)
                        if split == "train" else 1),
            flag_unwrap_phase=bool(params_data.get("flag_unwrap_phase",
                                                   False)),
            device=device)
    return out


def load_tensors(dataset, params_data, maxlen, cache_path=None):
    """(x, y, mask) numpy tensors, cached as ``.npz`` (enhance.py:363-382)."""
    if cache_path is not None and os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["x"], data["y"], data["mask"]
    x, y, mask = load_split(
        dataset, transform_x=params_data.get("transform_x", "mag"),
        transform_y=params_data.get("transform_y", "mag"), maxlen=maxlen)
    if cache_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)),
                    exist_ok=True)
        np.savez(cache_path, x=x, y=y, mask=mask)
    return x, y, mask


def _train_tensors(datasets, params_data, folder_exp):
    maxlen = params_data.get("maxlen", 500)
    train = load_tensors(datasets["train"], params_data, maxlen, cache_path=(
        os.path.join(folder_exp,
                     f"tensors_train_ds{params_data.get('downsample', 1)}"
                     f"_maxlen{maxlen}.npz")))
    valid = load_tensors(datasets["valid"], params_data, maxlen,
                         cache_path=os.path.join(
                             folder_exp, f"tensors_valid_maxlen{maxlen}.npz"))
    return train, valid


def _full_tensors(datasets, split, params_data, folder_exp):
    return load_tensors(datasets[split], params_data, None,
                        cache_path=os.path.join(folder_exp,
                                                f"tensors_{split}_full.npz"))


# ---------------------------------------------------------------------------
# mask prediction and reconstruction
# ---------------------------------------------------------------------------

def predict_irm(apply_fn, params, x, batch_size=250, mask_value=-1.0,
                bucket_frames=128, device="cuda"):
    """Masks for a padded (B, T_max, F) numpy split, by length buckets.

    Rows are grouped by true length into buckets of ``bucket_frames``
    frames, each run at its own length in batches of ``batch_size``:
    running every row at T_max would waste 2-3x the work on a real corpus.
    ``apply_fn(params, xb)`` gets a tensor on ``device`` and returns the
    mask as one.  It runs without gradients (``torch.no_grad``): a model
    whose parameters require them would otherwise take its training route.
    The model holds its state on padded steps, so a row's mask does not
    depend on its bucket."""
    device = resolve_device(device)
    irm = np.zeros_like(x)
    # a row's length is the index of its last unpadded frame + 1 (the
    # padding is a tail; an inner frame may equal the mask value)
    valid = np.any(x != mask_value, axis=-1)  # (B, T)
    t_max = x.shape[1]
    lengths = np.where(valid.any(axis=1),
                       t_max - valid[:, ::-1].argmax(axis=1), 0)
    buckets = {}
    for i, ln in enumerate(lengths):
        t_b = min(t_max, -(-max(int(ln), 1) // bucket_frames) * bucket_frames)
        buckets.setdefault(t_b, []).append(i)
    with torch.no_grad():
        for t_b, rows in sorted(buckets.items()):
            rows = np.asarray(rows)
            for start in range(0, len(rows), batch_size):
                idx = rows[start: start + batch_size]
                xb = torch.from_numpy(np.ascontiguousarray(x[idx, :t_b]))
                irm[idx, :t_b] = apply_fn(params, xb.to(device)).cpu().numpy()
    return irm


def reconstruct_split(dataset, irm, mask, description, fs=None,
                      bucket_frames=256):
    """Masked iSTFT and wav write for a whole split, on the dataset's
    device.

    Utterances are grouped into buckets of ``bucket_frames`` frames and
    each bucket is inverse-transformed as one batch (zero frames synthesize
    zeros and are cut off): one call a bucket where the reference looped
    one utterance at a time (enhance.py:1195-1203).  A wav has the length
    the reference's iSTFT gives (the noisy length rounded up to a multiple
    of the hop).  Multichannel stacks take the per-utterance path."""
    if fs is None:
        fs = dataset.fs
    n_fft = int(dataset.params_stft["N"])
    hop = int(dataset.params_stft["hop"])
    f_bins = n_fft // 2 + 1
    half = dataset.x_stack.shape[0] // 2
    if half != f_bins:  # multichannel
        for j in range(len(dataset.x_wavfiles)):
            len_cur = int(dataset.fidx[j, 1] - dataset.fidx[j, 0])
            dataset.reconstruct_audio(description, idx=j,
                                      irm=irm[j, :len_cur, :].T)
        return

    lens = (dataset.fidx[:, 1] - dataset.fidx[:, 0]).astype(int)
    if irm.shape[0] != len(dataset.x_wavfiles) or irm.shape[1] < lens.max():
        raise ValueError(
            f"reconstruct_split needs one irm row per wav file at full "
            f"length (build inference tensors with maxlen=None): got "
            f"irm {irm.shape} for {len(dataset.x_wavfiles)} files with "
            f"max {int(lens.max())} frames")
    buckets = {}
    for j, ln in enumerate(lens):
        buckets.setdefault(-(-ln // bucket_frames) * bucket_frames,
                           []).append(j)

    device = dataset.device
    window = torch.as_tensor(np.asarray(dataset.params_stft["window"],
                                        np.float32), device=device)
    for t_pad, idxs in sorted(buckets.items()):
        spec = np.zeros((len(idxs), t_pad, f_bins), np.complex64)
        for row, j in enumerate(idxs):
            seg = dataset.x_stack[:, dataset.fidx[j, 0]: dataset.fidx[j, 1]]
            masked = irm[j, : lens[j], :].T * (seg[:half] + 1j * seg[half:])
            spec[row, : lens[j]] = masked.T
        wavs = istft(torch.from_numpy(spec).to(device), n_fft, hop,
                     window).cpu().numpy()
        for row, j in enumerate(idxs):
            # the per-utterance iSTFT of L frames (N + hop*(L-1) samples,
            # N cut at each edge)
            nsampl = hop * (lens[j] - 1) - n_fft
            out = dataset.enhanced_path(j, description)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            wavwrite(out, fs, wavs[row: row + 1, :nsampl])


def score_split(dataset, description, datadir, compute_pesq=True,
                flag_rescore=False, verbose=True):
    """Per-SNR scoring: waits for ROADMAP.md queue A, item 8."""
    raise NotImplementedError(SCORING_NOT_PORTED)


def _enhance_splits(datasets, splits, params_data, folder_exp, apply_fn,
                    params, mask_value, prefix, timer, device):
    """Predict and reconstruct each split; the stages go to ``timer``."""
    sync = device.type == "cuda"
    for split in splits:
        ds = datasets[split]
        audio_s = dataset_audio_seconds(ds)
        with timer.stage(f"load_tensors:{split}"):
            x, _, mask = _full_tensors(datasets, split, params_data,
                                       folder_exp)
        with timer.stage(f"predict_irm:{split}", audio_seconds=audio_s,
                         sync=sync, group=split):
            irm = predict_irm(apply_fn, params, x, mask_value=mask_value,
                              device=device)
        with timer.stage(f"reconstruct:{split}", audio_seconds=audio_s,
                         sync=sync, group=split):
            reconstruct_split(ds, irm, mask, f"{prefix}_{split}")


# ---------------------------------------------------------------------------
# model runners
# ---------------------------------------------------------------------------

def _dict_from_config(params_model, params_data, datasets, folder_exp,
                      path_dicts, flag_recompute=False, verbose=True,
                      device="cuda"):
    """The two-stage SNMF dictionary from the training data (cached)."""
    params_snmf = snmf_params_from_config(params_model)
    cache = snmf_cache_path(params_snmf, path_dicts, prefix="noisy")
    if os.path.exists(cache) and not flag_recompute:
        w_noisy, _, _ = load_snmf(cache, load_h=False)
        return w_noisy, params_snmf
    (x, y, mask), _ = _train_tensors(datasets, params_data, folder_exp)
    w_noisy, _, _ = train_snmf(
        masked_seqs_to_frames(y, mask), masked_seqs_to_frames(x, mask),
        params_snmf, path_dicts=path_dicts, flag_recompute=flag_recompute,
        verbose=verbose, device=device)
    return w_noisy, params_snmf


def _start(params_data, folder_exp, flag_score, splits, device):
    """What every runner does first: refuse to score, then the device, the
    folders and the datasets."""
    if flag_score and splits:
        raise NotImplementedError(SCORING_NOT_PORTED)
    device = resolve_device(device)
    ensure_experiment_dirs(folder_exp)
    return device, build_datasets(params_data, device=device)


def _dicts_dir(folder_exp, path_dicts):
    if path_dicts is None:
        path_dicts = os.path.join(folder_exp, "dicts") + "/"
        os.makedirs(path_dicts, exist_ok=True)
    return path_dicts


def _train_config(params_model, verbose, learning_rate, clipnorm):
    return TrainConfig(
        epochs=int(params_model.get("epochs", 100)),
        batch_size=int(params_model.get("batch_size", 32)),
        learning_rate=float(params_model.get("learning_rate",
                                             learning_rate)),
        clipnorm=float(params_model.get("clipnorm", clipnorm)),
        decay=float(params_model.get("decay", 0.0)),
        patience=int(params_model.get("patience", 50)),
        seed=int(params_model.get("seed", 7654)),
        verbose=verbose)


def _needs_training(params_model, savefile, flag_recompute):
    need = flag_recompute or not os.path.exists(savefile)
    if bool(params_model.get("resume", False)) and not need:
        # a best checkpoint exists, but an interrupted fit may have epochs
        # to go: its resume state knows
        need = train_state_incomplete(
            savefile, int(params_model.get("epochs", 100)),
            int(params_model.get("patience", 50)))
    return need


def _load_params(path):
    params, _ = load_checkpoint(path)
    return {k: np.asarray(v) for k, v in params.items()}


def run_unfolded_snmf(params_model, params_data, folder_exp, path_dicts=None,
                      flag_recompute=False, flag_score=True,
                      compute_pesq=True, verbose=True,
                      splits=("valid", "test"), flag_rescore=False,
                      device="cuda"):
    """The 'unfolded_snmf' branch of the reference driver
    (enhance.py:933-1236).  Returns (best_params, config, results)."""
    device, datasets = _start(params_data, folder_exp, flag_score, splits,
                              device)
    path_dicts = _dicts_dir(folder_exp, path_dicts)
    timer = StageTimer()
    sync = device.type == "cuda"
    with timer.stage("dictionary", sync=sync):
        w_noisy, _ = _dict_from_config(params_model, params_data, datasets,
                                       folder_exp, path_dicts,
                                       flag_recompute, verbose, device)

    input_dim = int(params_data["params_stft"]["N"]) // 2 + 1
    config = drnmf_config_from_params(
        params_model, input_dim,
        mask_value=get_mask_value(params_data.get("transform_x", "mag"),
                                  params_data.get("transform_y", "mag")))
    params = init_drnmf_params(config, w_noisy, device=device)

    # run control ('resume'; 'fsdp' in the JAX package) stays out of the hash
    h = config_hash(params_model, exclude=("resume", "fsdp"))
    dump_yaml(params_model, os.path.join(
        folder_exp, "configs", f"params_unfolded_snmf_{h}.yaml"))
    savefile = os.path.join(folder_exp, "models",
                            f"model_unfolded_snmf_{h}.npz")
    histfile = os.path.join(folder_exp, "history",
                            f"history_unfolded_snmf_{h}")

    def loss_fn(p, x, y, mask):
        return masked_mse_signal_approx(drnmf_forward(p, config, x), x, y,
                                        mask)

    def train_loss_fn(p, x, y, mask, generator):
        irm = drnmf_forward(p, config, x, training=True, generator=generator)
        return masked_mse_signal_approx(irm, x, y, mask)

    use_dropout = config.dropout_W > 0 or config.dropout_U > 0
    pretrain = bool(params_model.get("pretrain_with_snmf_cost", False))
    savefile_pretrain = savefile.replace(".npz", "_pretrain.npz")
    need_train = _needs_training(params_model, savefile, flag_recompute)
    need_pretrain = pretrain and (flag_recompute
                                  or not os.path.exists(savefile_pretrain))
    if need_train or need_pretrain:
        train_data, valid_data = _train_tensors(datasets, params_data,
                                                folder_exp)
        tc = _train_config(params_model, verbose, 1e-3, 0.0)

    if pretrain:
        # SNMF-cost pretraining (enhance.py:1024-1120): the unfolded
        # network's own sparse-coding objective, best-val checkpointed,
        # then the signal-approximation fit starts from those weights
        lam1 = float(params_model["lam1"])

        def pretrain_loss_fn(p, x, y, mask):
            _, hidden, clean_est, noise_est = drnmf_forward(
                p, config, x, return_parts=True)
            return snmf_pretrain_loss(clean_est, noise_est, hidden, x, mask,
                                      lam1)

        if need_pretrain:
            if verbose:
                print("Pretraining with the SNMF cost...")
            with timer.stage("pretrain", sync=sync):
                train_model(params, pretrain_loss_fn, train_data, valid_data,
                            tc,
                            trainable_mask=drnmf_trainable_mask(config,
                                                                params),
                            savefile=savefile_pretrain,
                            histfile=histfile + "_pretrain", device=device)
        params = _load_params(savefile_pretrain)
        config = ensure_fold_valid(config, params, verbose=verbose)

    if need_train:
        if "savefile_init" in params_model:
            params = _load_params(params_model["savefile_init"])
            config = ensure_fold_valid(config, params, verbose=verbose)
        with timer.stage("train", sync=sync):
            best_params, _ = train_model(
                params, train_loss_fn if use_dropout else loss_fn,
                train_data, valid_data, tc,
                trainable_mask=drnmf_trainable_mask(config, params),
                savefile=savefile, histfile=histfile,
                eval_loss_fn=loss_fn if use_dropout else None,
                loss_takes_rng=use_dropout,
                resume=bool(params_model.get("resume", False)),
                device=device)
    else:
        best_params = _load_params(savefile)
    config = ensure_fold_valid(config, best_params, verbose=verbose)

    _enhance_splits(datasets, splits, params_data, folder_exp,
                    lambda p, xb: drnmf_forward(p, config, xb),
                    params_from_numpy(best_params, device),
                    config.mask_value, f"unfolded_snmf_{h}", timer, device)
    if verbose:
        print(f"Timing:\n{timer.report()}")
    return best_params, config, {"timer": timer}


def run_lstm(params_model, params_data, folder_exp, flag_recompute=False,
             flag_score=True, compute_pesq=True, verbose=True,
             splits=("valid", "test"), flag_rescore=False, device="cuda"):
    """The 'lstm' branch (enhance.py:1239-1388).  Returns (best_params,
    config, results)."""
    device, datasets = _start(params_data, folder_exp, flag_score, splits,
                              device)
    timer = StageTimer()
    input_dim = int(params_data["params_stft"]["N"]) // 2 + 1
    config = LSTMConfig(
        input_dim=input_dim, hidden_dim=int(params_model["hidden_dim"]),
        output_dim=input_dim, K_layers=int(params_model["K_layers"]),
        mask_value=get_mask_value(params_data.get("transform_x", "mag"),
                                  params_data.get("transform_y", "mag")))

    h = config_hash(params_model, exclude=("resume", "fsdp"))
    dump_yaml(params_model,
              os.path.join(folder_exp, "configs", f"params_lstm_{h}.yaml"))
    savefile = os.path.join(folder_exp, "models", f"model_lstm_{h}.npz")
    histfile = os.path.join(folder_exp, "history", f"history_lstm_{h}")

    def loss_fn(p, x, y, mask):
        return masked_mse_signal_approx(lstm_forward(p, config, x), x, y,
                                        mask)

    if _needs_training(params_model, savefile, flag_recompute):
        train_data, valid_data = _train_tensors(datasets, params_data,
                                                folder_exp)
        with timer.stage("train", sync=device.type == "cuda"):
            best_params, _ = train_model(
                init_lstm_params(config, device=device), loss_fn, train_data,
                valid_data, _train_config(params_model, verbose, 1e-4, 1.0),
                savefile=savefile, histfile=histfile,
                resume=bool(params_model.get("resume", False)),
                device=device)
    else:
        best_params = _load_params(savefile)

    _enhance_splits(datasets, splits, params_data, folder_exp,
                    lambda p, xb: lstm_forward(p, config, xb),
                    params_from_numpy(best_params, device),
                    config.mask_value, f"lstm_{h}", timer, device)
    if verbose:
        print(f"Timing:\n{timer.report()}")
    return best_params, config, {"timer": timer}


def run_snmf(params_model, params_data, folder_exp, path_dicts=None,
             flag_recompute=False, flag_score=True, compute_pesq=True,
             verbose=True, splits=("valid", "test"), flag_rescore=False,
             device="cuda"):
    """The 'snmf' branch (enhance.py:750-928): the dictionary, and MU
    inference with W frozen as the enhancer.  Returns (w_noisy,
    params_snmf, results)."""
    device, datasets = _start(params_data, folder_exp, flag_score, splits,
                              device)
    path_dicts = _dicts_dir(folder_exp, path_dicts)
    timer = StageTimer()
    sync = device.type == "cuda"
    with timer.stage("dictionary", sync=sync):
        w_noisy, params_snmf = _dict_from_config(
            params_model, params_data, datasets, folder_exp, path_dicts,
            flag_recompute, verbose, device)
    h = config_hash(params_model)
    dump_yaml(params_model,
              os.path.join(folder_exp, "configs", f"params_snmf_{h}.yaml"))
    histfile = os.path.join(folder_exp, "history", f"history_snmf_{h}")

    for split in splits:
        ds = datasets[split]
        audio_s = dataset_audio_seconds(ds)
        with timer.stage(f"load_tensors:{split}"):
            x, y, mask = _full_tensors(datasets, split, params_data,
                                       folder_exp)
        with timer.stage(f"predict_irm:{split}", audio_seconds=audio_s,
                         sync=sync, group=split):
            x_frames = masked_seqs_to_frames(x, mask).numpy()
            irm_frames, _ = snmf_infer_irm(
                x_frames, w_noisy, params_snmf,
                max_iter=int(params_model.get("infer_max_iter", 200)),
                device=device)
        if split == "valid":
            y_frames = masked_seqs_to_frames(y, mask).numpy()
            val_loss = float(np.mean((irm_frames * x_frames - y_frames) ** 2))
            with open(histfile, "wb") as f:
                pickle.dump({"on_epoch_end": {"val_loss": [val_loss]}}, f)
            if verbose:
                print(f"SNMF signal-approximation val_loss: {val_loss:.6f}")
        # the frame stack back into the split's padded (B, T, F) layout,
        # one row a file, for the bucketed reconstruction
        irm = np.zeros_like(x)
        for j in range(len(ds.x_wavfiles)):
            ln = int(ds.fidx[j, 1] - ds.fidx[j, 0])
            irm[j, :ln] = irm_frames[:, ds.fidx[j, 0]: ds.fidx[j, 1]].T
        with timer.stage(f"reconstruct:{split}", audio_seconds=audio_s,
                         sync=sync, group=split):
            reconstruct_split(ds, irm, mask, f"snmf_{h}_{split}")
    if verbose:
        print(f"Timing:\n{timer.report()}")
    return w_noisy, params_snmf, {"timer": timer}
