"""The port's tooling on the CPU, against the JAX package where it has a
counterpart: ``utils.profiling.trace`` and the CLI's ``--trace``, the
Keras HDF5 weight import (``utils.convert``, ``python -m
drnmf_torch.import_reference_weights``), the experiment commands
(``run_waspaa2017``, ``print_scores``, ``plot_learning_curves``,
``create_taskfiles``), ISTA (``ops.ista``) and the sharded checkpoint.

The JAX scripts run in this process (``runpy``), their output captured
beside the port module's.  Tolerances: imported parameters, checkpoints
and tables exact; ISTA rtol 1e-5 / atol 1e-7 against ``drnmf_tpu.ops``
(f32 on both sides; atol for entries the soft threshold sets to zero on
one side and to a rounding residue on the other); the divergences rtol
1e-5 / atol 1e-6 (a sum of O(1) terms that cancels where x ~ y, leaving
their f32 rounding, a few 1e-7).
"""

import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def one_thread():
    """Each test and its ranks on one intra-op thread (the suite runs
    beside other test processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_script(name, argv, monkeypatch):
    """Run ``scripts/<name>.py`` with ``argv`` as its command line."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    runpy.run_path(os.path.join(SCRIPTS, f"{name}.py"), run_name="__main__")


def _corpus(tmp_path):
    """The verify recipe's corpus and YAMLs (6 files, K=2, r=8)."""
    import yaml
    from drnmf_torch.data import make_synthetic_corpus

    tf = make_synthetic_corpus(str(tmp_path / "audio"), n_files=6,
                               min_sec=0.5, max_sec=0.9)
    data = {"transform_x": "mag", "transform_y": "mag",
            "params_stft": {"N": 256, "hop": 64, "nch": 1},
            "maxlen": 60, "downsample": 1}
    for split in ("train", "valid", "test"):
        data[f"taskfile_x_{split}"] = tf["noisy"]
        data[f"taskfile_y_{split}"] = tf["clean"]
    model = {"K_layers": 2, "r": 8, "alph": 10.0, "lam1": 0.5, "epochs": 2,
             "batch_size": 4, "learning_rate": 1e-3, "clipnorm": 0.0,
             "patience": 50, "params_untied": ["log_D", "log_alph"],
             "params_trainable": ["log_D", "log_alph"],
             "snmf_max_iter": 20, "snmf_conv_eps": 1e-4}
    paths = {}
    for name, cfg in (("data", data), ("unfolded_snmf_t", model)):
        paths[name] = str(tmp_path / f"params_{name}.yaml")
        with open(paths[name], "w") as fh:
            yaml.safe_dump(cfg, fh)
    return paths


# ---------------------------------------------------------------------------
# trace and --trace
# ---------------------------------------------------------------------------

def _trace_names(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return {e.get("name") for e in events}


def _span_names(path):
    with open(path) as fh:
        return set(json.load(fh)["spans"])


def test_trace_and_cli_trace(tmp_path, monkeypatch):
    """``trace(None)`` does nothing; ``trace(dir)`` writes
    ``trace_rank0.json`` with the block's ``StageTimer`` ranges and
    ``spans_rank0.json`` with their spans; ``device_sync`` on the CPU
    returns.  A tiny ``--device cpu`` CLI run with ``--trace`` writes one
    Chrome trace and one tally holding the pipeline's stage names, and
    ``--dp 2 --trace`` one of each a rank, each holding its stages."""
    from drnmf_torch import cli
    from drnmf_torch.utils import StageTimer, device_sync, trace

    with trace(None) as prof:
        assert prof is None
    device_sync()
    timer = StageTimer()
    with trace(str(tmp_path / "block"), device="cpu") as prof:
        with timer.stage("outer"):
            with timer.stage("inner"):
                torch.ones(4) @ torch.ones(4)
    assert sorted(os.listdir(tmp_path / "block")) == ["spans_rank0.json",
                                                      "trace_rank0.json"]
    assert {"outer", "inner"} <= _trace_names(
        tmp_path / "block" / "trace_rank0.json")
    assert {"outer", "inner"} <= _span_names(
        tmp_path / "block" / "spans_rank0.json")

    paths = _corpus(tmp_path)

    def run(exp, *extra):
        cli.main(["-c", paths["unfolded_snmf_t"], "-d", paths["data"],
                  "--exp-dir", str(tmp_path / exp), "--splits", "valid",
                  "--no-score", "--device", "cpu", "-q", *extra])

    run("one", "--trace", str(tmp_path / "t1"))
    assert sorted(os.listdir(tmp_path / "t1")) == ["spans_rank0.json",
                                                   "trace_rank0.json"]
    stages = {"dictionary", "train", "load_tensors:valid",
              "predict_irm:valid", "reconstruct:valid"}
    names = _trace_names(tmp_path / "t1" / "trace_rank0.json")
    assert stages <= names, names
    spans = _span_names(tmp_path / "t1" / "spans_rank0.json")
    assert stages | {"train.step"} <= spans, spans
    run("two", "--dp", "2", "--trace", str(tmp_path / "t2"))
    assert sorted(os.listdir(tmp_path / "t2")) == [
        "spans_rank0.json", "spans_rank1.json", "trace_rank0.json",
        "trace_rank1.json"]
    for rank in (0, 1):
        names = _trace_names(tmp_path / "t2" / f"trace_rank{rank}.json")
        assert {"dictionary", "train"} <= names, (rank, names)
        spans = _span_names(tmp_path / "t2" / f"spans_rank{rank}.json")
        assert {"dictionary", "train"} <= spans, (rank, spans)


# ---------------------------------------------------------------------------
# the Keras HDF5 import
# ---------------------------------------------------------------------------

def _keras_files(tmp_path, rng):
    """(path, JAX config, port config, params) of the HDF5 files
    tests/test_convert.py builds: DR-NMF untied, tied (K=3), untied alph
    vectors, and the K=5 LSTM stack."""
    from drnmf_tpu.models import DRNMFConfig as JaxDRNMF
    from drnmf_tpu.models import LSTMConfig as JaxLSTM
    from drnmf_tpu.models import init_drnmf_params, init_lstm_params
    from drnmf_torch.models.drnmf import DRNMFConfig
    from drnmf_torch.models.lstm import LSTMConfig
    from test_convert import write_keras_h5

    out = []
    for name, f, r, K, kw in (
            ("model_unfolded_snmf_abc", 9, 3, 2,
             dict(params_untied=("log_D", "log_alph"))),
            ("model_unfolded_snmf_tied", 7, 3, 3, dict(params_untied=())),
            ("model_unfolded_snmf_ua", 6, 2, 2,
             dict(untie_alph=True, params_untied=("log_D", "log_alph")))):
        kw = dict(input_dim=f, r=r, output_dim=f, K_layers=K, alph=10.0,
                  lam1=0.5, **kw)
        w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
        w /= np.sqrt(np.sum(w**2, axis=0))
        jcfg = JaxDRNMF(**kw)
        params = {k: np.asarray(v) + np.float32(0.01)
                  for k, v in init_drnmf_params(jcfg, w).items()}
        rnn = "simple_deep_rnn_1"
        weights = [(f"{rnn}_{k}", v) for k, v in sorted(params.items())
                   if not k.startswith("log_W_")]
        path = str(tmp_path / f"{name}.hdf5")
        write_keras_h5(path, [
            ("masking_1", []), (rnn, weights),
            ("clean_est", [("clean_est/kernel:0", params["log_W_clean"])]),
            ("noise_est", [("noise_est/kernel:0", params["log_W_noise"])])])
        out.append((path, jcfg, DRNMFConfig(**kw), params))
    lkw = dict(input_dim=6, hidden_dim=4, output_dim=6, K_layers=5)
    params = {k: np.asarray(v)
              for k, v in init_lstm_params(JaxLSTM(**lkw)).items()}
    layers = [("masking_1", [])]
    for k in range(5):
        nm = f"lstm_{k + 1}"
        layers.append((nm, [(f"{nm}/kernel:0", params[f"lstm{k}_Wx"]),
                            (f"{nm}/recurrent_kernel:0",
                             params[f"lstm{k}_Wh"]),
                            (f"{nm}/bias:0", params[f"lstm{k}_b"])]))
    layers.append(("time_distributed_1", [
        ("time_distributed_1/kernel:0", params["dense_W"]),
        ("time_distributed_1/bias:0", params["dense_b"])]))
    path = str(tmp_path / "model_lstm_k5.hdf5")
    write_keras_h5(path, layers)
    out.append((path, JaxLSTM(**lkw), LSTMConfig(**lkw), params))
    return out


def _raises(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def test_keras_import_matches_jax(tmp_path, rng, monkeypatch, capsys):
    """``utils.convert`` against ``drnmf_tpu.utils.convert`` on the HDF5
    files of tests/test_convert.py: the same keys and arrays (equal to the
    written parameters), the same ``validate_*`` verdicts and messages on
    pristine, transposed, short, long and plain-h0 dicts, the same refusal
    of a foreign file; ``python -m drnmf_torch.import_reference_weights``
    (validating against a YAML) writes the npz the JAX script writes, and
    both packages' ``load_checkpoint`` read it back equal."""
    import yaml
    from drnmf_tpu.train import load_checkpoint as jax_load
    from drnmf_tpu.utils import convert as jconv
    from drnmf_torch import import_reference_weights
    from drnmf_torch.train import load_checkpoint
    from drnmf_torch.utils import convert
    from test_convert import write_keras_h5

    for path, jcfg, tcfg, params in _keras_files(tmp_path, rng):
        lstm = "lstm" in path
        fn = "import_lstm_keras_weights" if lstm else \
            "import_drnmf_keras_weights"
        got, want = getattr(convert, fn)(path), getattr(jconv, fn)(path)
        assert sorted(got) == sorted(want) == sorted(params), path
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], params[k], err_msg=k)
        vname = "validate_lstm_import" if lstm else "validate_drnmf_import"
        first = sorted(params)[0]
        bad = {"pristine": dict(params),
               "short": {k: v for k, v in params.items() if k != first},
               "long": {**params, "log_D_9": params[first]},
               "transposed": {**params, **{
                   k: params[k].T for k in ("dense_W", "log_W_clean")
                   if k in params}}}
        for case, p in bad.items():
            msg = _raises(getattr(convert, vname), p, tcfg)
            assert msg == _raises(getattr(jconv, vname), p, jcfg), (path,
                                                                    case)
            assert (msg is None) == (case == "pristine"), (path, case, msg)
    other = str(tmp_path / "other.hdf5")
    write_keras_h5(other, [("dense_1", [("dense_1/kernel:0",
                                         np.zeros((3, 3), np.float32))])])
    for fn in ("import_drnmf_keras_weights", "import_lstm_keras_weights"):
        msg = _raises(getattr(convert, fn), other)
        assert msg and msg == _raises(getattr(jconv, fn), other)
    from drnmf_torch.convert import init_drnmf_params
    from drnmf_torch.models.drnmf import DRNMFConfig
    plain_h0 = DRNMFConfig(input_dim=7, r=3, output_dim=7, K_layers=2,
                           nonnegative=False)
    convert.validate_drnmf_import(init_drnmf_params(
        plain_h0, np.full((7, 6), 0.5, np.float32), device="cpu"), plain_h0)

    # the command, against the JAX script
    path = _keras_files(tmp_path, rng)[0][0]
    cfg = str(tmp_path / "params_unfolded_snmf_abc.yaml")
    with open(cfg, "w") as fh:
        yaml.safe_dump({"K_layers": 2, "r": 3, "alph": 10.0, "lam1": 0.5,
                        "params_untied": ["log_D", "log_alph"]}, fh)
    port_npz = str(tmp_path / "port.npz")
    import_reference_weights.main([path, "-o", port_npz, "-c", cfg,
                                   "--n-fft", "16"])
    port_out = capsys.readouterr().out
    _jax_script("import_reference_weights",
                [path, "-o", str(tmp_path / "jax.npz"), "-c", cfg,
                 "--n-fft", "16"], monkeypatch)
    jax_out = capsys.readouterr().out
    assert port_out.replace("port.npz", "X") == jax_out.replace("jax.npz",
                                                                "X")
    want, _ = jax_load(str(tmp_path / "jax.npz"))
    for loader in (load_checkpoint, jax_load):
        got, meta = loader(port_npz)
        assert sorted(got) == sorted(want) and meta == {}
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])


# ---------------------------------------------------------------------------
# the experiment commands
# ---------------------------------------------------------------------------

def _tree(root):
    """relative path -> file text of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full) as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


def test_run_waspaa2017_matches_jax_script(tmp_path, monkeypatch, capsys):
    """``--generate-only`` (10 configs in two setups), ``--smoke
    --generate-only`` and ``--demo --generate-only`` write the files the
    JAX script writes, with the same hashed names and YAML; ``--smoke
    --dry-run --cli-args`` prints the port's CLI commands with the
    arguments appended and runs nothing."""
    from drnmf_torch import run_waspaa2017

    for argv in (["--generate-only"], ["--smoke", "--generate-only"],
                 ["--demo", "--generate-only", "--downsamples", "10"]):
        trees = []
        for who in ("jax", "port"):
            where = tmp_path / "_".join([who] + argv).replace("-", "")
            where.mkdir()
            monkeypatch.chdir(where)
            if who == "jax":
                _jax_script("run_waspaa2017", argv, monkeypatch)
            else:
                run_waspaa2017.main(argv)
            trees.append((_tree(where), capsys.readouterr().out))
        assert trees[0][0] == trees[1][0], argv
        assert trees[0][1] == trees[1][1], argv
        n_cfg = sum(p.startswith("data_setup_downsample10/configs/")
                    for p in trees[1][0])
        assert n_cfg == (3 if "--smoke" in argv else 10), argv
    monkeypatch.chdir(tmp_path)
    run_waspaa2017.main(["--smoke", "--dry-run", "--cli-args",
                         "--dp 4 --fsdp"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("== run:")]
    assert len(lines) == 3
    assert all(line.startswith("== run: python -m drnmf_torch.cli -c ")
               and line.endswith("--dp 4 --fsdp") for line in lines)


def _score_fixture(tmp_path):
    """Two experiment folders (downsample 1 and 10) with configs,
    checkpoints, histories and per-SNR score files of three models."""
    import yaml

    rng = np.random.default_rng(3)
    wavs = tmp_path / "wavs.txt"
    wavs.write_text("\n".join(f"f{i}.wav" for i in range(40)) + "\n")
    folders = []
    for ds in (1, 10):
        exp = tmp_path / f"exp{ds}"
        for sub in ("configs", "scores", "models", "history"):
            (exp / sub).mkdir(parents=True)
        with open(exp / "params_data.yaml", "w") as fh:
            yaml.safe_dump({"downsample": ds,
                            "taskfile_x_train": str(wavs)}, fh)
        for tag, cfg, keys in (
                ("unfolded_snmf_h64", {"K_layers": 2, "r": 64,
                                       "params_trainable": ["log_D"]},
                 {"log_D_0": (9, 128), "log_D_1": (9, 128),
                  "log_h0": (128,), "log_U1": (128, 128)}),
                ("unfolded_snmf_h512", {"K_layers": 5, "r": 512}, None),
                ("lstm_h54", {"K_layers": 2, "hidden_dim": 54},
                 {"lstm0_Wx": (9, 216), "dense_W": (54, 9)})):
            with open(exp / "configs" / f"params_{tag}.yaml", "w") as fh:
                yaml.safe_dump(cfg, fh)
            if keys:
                np.savez(exp / "models" / f"model_{tag}.npz",
                         **{k: np.zeros(s, np.float32)
                            for k, s in keys.items()})
                hist = {"on_epoch_end": {"loss": [0.3, 0.2, 0.1],
                                         "val_loss": list(rng.uniform(
                                             0.1, 0.5, 3))},
                        "on_batch_end": {"loss": list(range(12))}}
                with open(exp / "history" / f"history_{tag}", "wb") as fh:
                    pickle.dump(hist, fh)
            for split in ("valid", "test"):
                for snr in ("m6dB", "0dB", "9dB"):
                    S = rng.uniform(0, 10, (3, 6))
                    np.savez(exp / "scores"
                             / f"scores_{tag}_{split}_{snr}.npz", S=S)
        folders.append(str(exp))
    return folders


def test_print_scores_and_curves_match_jax(tmp_path, monkeypatch, capsys):
    """``print_scores`` on the same fixture folders prints what the JAX
    script prints: plain, ``--latex``, ``--per-snr``, two folders in one
    table, and the refusal of a folder with no configs;
    ``plot_learning_curves`` prints the JAX script's text where
    matplotlib is absent, and with it writes the image."""
    from drnmf_torch import plot_learning_curves, print_scores

    folders = _score_fixture(tmp_path)
    for argv in ([folders[0]], [folders[0], "--latex"],
                 [folders[0], "--per-snr"], folders,
                 folders + ["--latex", "--splits", "valid"]):
        _jax_script("print_scores", argv, monkeypatch)
        want = capsys.readouterr().out
        print_scores.main(argv)
        assert capsys.readouterr().out == want, argv
        assert want.strip(), argv
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no configs"):
        print_scores.main([empty])

    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)  # import fails
        for argv in ([folders[0]], [folders[1], "--iterations-per-epoch",
                                    "530"]):
            _jax_script("plot_learning_curves", argv, m)
            want = capsys.readouterr().out
            plot_learning_curves.main(argv)
            got = capsys.readouterr().out
            assert got == want and "matplotlib unavailable" in got, argv
    out = str(tmp_path / "curves.png")
    plot_learning_curves.main([folders[0], "--out", out])
    assert os.path.getsize(out) > 0


def test_create_taskfiles_matches_jax(tmp_path):
    """On a CHiME2-shaped tree (isolated/ and scaled/ x the three subsets,
    nested SNR folders, a stray non-wav), the port writes the JAX script's
    six taskfiles, each the sorted list of that subset's wavs."""
    from drnmf_torch import create_taskfiles

    root = tmp_path / "chime2"
    for tree in ("isolated", "scaled"):
        for i, subset in enumerate(("si_tr_s", "si_dt_05", "si_et_05")):
            for snr in ("0dB", "m3dB"):
                d = root / tree / subset / snr
                d.mkdir(parents=True)
                for j in range(i + 1):
                    (d / f"utt{j}.wav").write_bytes(b"RIFF")
                (d / "notes.txt").write_text("x")
    ns = runpy.run_path(os.path.join(SCRIPTS, "create_taskfiles.py"))
    ns["write_taskfiles"](str(root), str(tmp_path / "jax"))
    written = create_taskfiles.main([str(root), "--out-dir",
                                     str(tmp_path / "port")])
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    assert len(written) == 6
    for key, path in written.items():
        split, cond = key.split("_")
        subset = create_taskfiles.SPLITS[split]
        tree = create_taskfiles.CONDITIONS[cond]
        want = sorted(str(p) for p in (root / tree / subset).rglob("*.wav"))
        with open(path) as fh:
            assert fh.read().splitlines() == want, key


# ---------------------------------------------------------------------------
# ISTA
# ---------------------------------------------------------------------------

def test_ista_matches_jax(rng):
    """``ista_ed``, ``ista_kl``, ``ista_beta`` (and the ``ista`` dispatch)
    for beta 2, 1, 0 and 0.5, and ``kl_div``/``beta_div``, against
    ``drnmf_tpu.ops`` on the same inputs (m=21, r=12, n=30, 6 steps)."""
    import jax.numpy as jnp
    from drnmf_tpu import ops as jops
    from drnmf_torch import ops

    tol, div_tol = dict(rtol=1e-5, atol=1e-7), dict(rtol=1e-5, atol=1e-6)
    m, r, n = 21, 12, 30
    x = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    w = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    h = rng.uniform(0.1, 1.0, (r, n)).astype(np.float32)
    y = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         (("x", x), ("w", w), ("h", h), ("y", y))}
    j = {k: jnp.asarray(v) for k, v in (("x", x), ("w", w), ("h", h),
                                        ("y", y))}
    lam1, alph, steps = 0.05, 20.0, 6
    for beta in (2.0, 1.0, 0.0, 0.5):
        got = ops.ista(t["x"], t["w"], t["h"], lam1, alph, steps, beta=beta)
        want = jops.ista(j["x"], j["w"], j["h"], lam1, alph, steps,
                         beta=beta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=f"ista beta={beta}")
        assert float(got.max()) > 0, beta
        np.testing.assert_allclose(
            ops.beta_div(t["x"], t["y"], beta).numpy(),
            np.asarray(jops.beta_div(j["x"], j["y"], beta)), **div_tol,
            err_msg=f"beta_div beta={beta}")
    for fn, args in (("ista_ed", ()), ("ista_kl", ()), ("ista_beta", (0.5,))):
        got = getattr(ops, fn)(t["x"], t["w"], t["h"], lam1, alph, steps,
                               *args)
        want = getattr(jops, fn)(j["x"], j["w"], j["h"], lam1, alph, steps,
                                 *args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=fn)
    np.testing.assert_allclose(ops.kl_div(t["x"], t["y"]).numpy(),
                               np.asarray(jops.kl_div(j["x"], j["y"])),
                               **div_tol)


# ---------------------------------------------------------------------------
# the sharded checkpoint
# ---------------------------------------------------------------------------

def _ckpt_params(rng):
    """Parameters of a K=2, r=128, F=257 model (log_D_k and log_U1 are over
    the FSDP rule's 65,536 elements, so they shard) plus a small vector."""
    from drnmf_torch.convert import init_drnmf_params
    from drnmf_torch.models.drnmf import DRNMFConfig

    cfg = DRNMFConfig(input_dim=257, r=128, output_dim=257, K_layers=2)
    w = rng.uniform(0.05, 1.0, (257, 256)).astype(np.float32)
    params = init_drnmf_params(cfg, w, device="cpu")
    return {k: (v + torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                     .astype(np.float32)) * 1e-3)
            for k, v in params.items()}


def _ckpt_rank(rank, params, path_blocks, path_whole):
    from drnmf_torch.parallel import fsdp_shard_params, make_mesh
    from drnmf_torch.train import save_checkpoint_sharded

    mesh = make_mesh(device="cpu")
    shards, dims = fsdp_shard_params(params, mesh)
    save_checkpoint_sharded(path_blocks, shards, meta={"epoch": 7},
                            mesh=mesh, dims=dims)
    save_checkpoint_sharded(path_whole, params, meta={"epoch": 7}, mesh=mesh)
    return dims


def test_sharded_checkpoint_round_trip(tmp_path, rng):
    """One process writes and reads back every tensor bit-equal, with its
    meta; two gloo ranks under FSDP each write only their own blocks
    (``fsdp_shard_params``: a sharded tensor's blocks in one file a rank,
    a replicated tensor in one file), or, given whole tensors and no
    ``dims``, each tensor once; one process loads them whole, bit-equal."""
    import torch.distributed.checkpoint as dcp
    from drnmf_torch.parallel import run_ranks
    from drnmf_torch.train import (load_checkpoint_sharded,
                                   save_checkpoint_sharded)

    params = _ckpt_params(rng)
    meta = {"epoch": 3, "val_loss": np.float32(0.25)}
    save_checkpoint_sharded(str(tmp_path / "one"), params, meta=meta)
    got, got_meta = load_checkpoint_sharded(str(tmp_path / "one"))
    assert sorted(got) == sorted(params) and got_meta == meta
    for k in params:
        assert torch.equal(got[k], params[k]), k

    host = {k: v.numpy() for k, v in params.items()}
    paths = [str(tmp_path / "blocks"), str(tmp_path / "whole")]
    dims = run_ranks(_ckpt_rank, 2, args=(host, *paths), device="cpu",
                     timeout_s=TIMEOUT_S, deadline_s=2 * TIMEOUT_S)
    sharded = {k for k, d in dims[0].items() if d is not None}
    assert {"log_D_0", "log_D_1", "log_U1", "log_Uk"} <= sharded
    assert "log_h0" not in sharded
    for path in paths:
        got, got_meta = load_checkpoint_sharded(path)
        assert sorted(got) == sorted(params) and got_meta == {"epoch": 7}
        for k in params:
            assert torch.equal(got[k], params[k]), (path, k)
        files = {}
        for index, info in dcp.FileSystemReader(path).read_metadata() \
                .storage_data.items():
            files.setdefault(index.fqn, set()).add(info.relative_path)
        for k in params:
            want = 2 if k in sharded and path == paths[0] else 1
            assert len(files[f"params.{k}"]) == want, (path, k, files)
