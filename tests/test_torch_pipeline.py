"""The experiment pipeline and command line of the port (drnmf_torch.cli,
drnmf_torch.pipeline, drnmf_torch.reporting) against the JAX package's, on
the CPU.

Both packages run the verify recipe's small experiment (K = 2, r = 8, 6
synthetic files, n_fft 256, hop 64, maxlen 60, 2 epochs) on copies of one
corpus (the same wav bytes), each with its own experiment folder and
dictionary folder; the JAX dictionary is copied into the port's, and both
fits start from the JAX package's initial values (``savefile_init``), so
the two start from one W and one set of parameters (their random number
generators differ).  The JAX pipeline without scoring writes no wavs, so
its masks and wavs come from its own ``predict_irm`` and
``reconstruct_split`` on its best checkpoint.  Tolerances: the best
checkpoints rtol 1e-4 / atol 1e-5; enhanced wavs within 1e-4 of their
peak plus one int16 step (1/32768, which a smaller difference can flip);
each file's SDR (``drnmf_tpu/metrics/bss_eval.py`` on both) within 0.1 dB,
the repo's budget; the SNMF enhancer's masks (H from ones on both sides)
rtol 2e-5 / atol 1e-6, as ``tests/test_torch_snmf.py`` holds them; the
LSTM's best checkpoint as the DR-NMF's.  Scored, each package with its own
metrics on its own wavs: the same score file names, the overall SDR, SNR
and segmental SNR within 0.1 dB (the budget), PESQ within 2e-3 MOS and
STOI within 1e-3 (``tests/test_torch_metrics.py``'s tolerances).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile
import yaml

import drnmf_tpu.data as jdata
from drnmf_tpu import cli as jcli
from drnmf_tpu import pipeline as jpipe
from drnmf_tpu import reporting as jreporting
from drnmf_tpu.metrics import scoring as jscoring
from drnmf_tpu.metrics.bss_eval import bss_eval_sdr
from drnmf_tpu.models import drnmf as jdrnmf
from drnmf_tpu.models import lstm as jlstm
from drnmf_tpu.train import checkpoint as jcheckpoint
from drnmf_torch import cli as tcli
from drnmf_torch import pipeline as tpipe
from drnmf_torch import reporting as treporting
from drnmf_torch.config import config_hash
from drnmf_torch.convert import params_from_numpy

DRNMF = {"K_layers": 2, "r": 8, "alph": 10.0, "lam1": 0.5, "epochs": 2,
         "batch_size": 4, "learning_rate": 1e-3, "clipnorm": 0.0,
         "patience": 50, "params_untied": ["log_D", "log_alph"],
         "params_trainable": ["log_D", "log_alph"], "snmf_max_iter": 20,
         "snmf_conv_eps": 1e-4}
SNMF = {"r": 8, "lam1": 0.5, "cf": "ed", "snmf_max_iter": 20,
        "snmf_conv_eps": 1e-4, "infer_max_iter": 30, "random_seed": 2016}
LSTM = {"K_layers": 2, "hidden_dim": 8, "epochs": 2, "batch_size": 4,
        "learning_rate": 1e-3, "clipnorm": 1.0, "patience": 50}
INT16_STEP = 1.0 / 32768
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _experiment(tmp_path, who):
    """A corpus copy and a data config for ``who``; returns (data config,
    its YAML path, the experiment folder)."""
    root = tmp_path / who
    tf = jdata.make_synthetic_corpus(str(root / "audio"), n_files=6,
                                     min_sec=0.5, max_sec=0.9)
    data = {"transform_x": "mag", "transform_y": "mag",
            "params_stft": {"N": 256, "hop": 64, "nch": 1},
            "maxlen": 60, "downsample": 1}
    for split in ("train", "valid", "test"):
        data[f"taskfile_x_{split}"] = tf["noisy"]
        data[f"taskfile_y_{split}"] = tf["clean"]
    path = root / "params_data.yaml"
    path.write_text(yaml.safe_dump(data))
    return data, str(path), str(root / "exp")


def _model_yaml(tmp_path, name, model):
    path = tmp_path / f"params_{name}_t.yaml"
    path.write_text(yaml.safe_dump(model))
    return str(path)


def _wav(path):
    return scipy.io.wavfile.read(path)[1].astype(np.float64) / 32768.0


def _cli(model_yaml, data_yaml, exp, *extra, score=False):
    return tcli.main(["-c", model_yaml, "-d", data_yaml, "--exp-dir", exp,
                      "--splits", "valid", "--device", "cpu", "-q", *extra,
                      *(() if score else ("--no-score",))])


def _compare_wavs(jds, desc, tds, sdr=True):
    """Every enhanced wav of the port against the JAX package's: within
    1e-4 of the peak plus an int16 step, and SDR within 0.1 dB.  Returns
    the largest SDR difference."""
    worst = 0.0
    for j, clean in enumerate(jds.y_wavfiles):
        want = _wav(jds.enhanced_path(j, desc))
        got = _wav(tds.enhanced_path(j, desc))
        assert got.shape == want.shape, j
        assert np.abs(got - want).max() <= (1e-4 * np.abs(want).max()
                                            + INT16_STEP), (desc, j)
        if sdr:
            ref = _wav(clean)
            d = abs(bss_eval_sdr(got, ref) - bss_eval_sdr(want, ref))
            assert d <= 0.1, (desc, j, d)
            worst = max(worst, d)
    return worst


def test_unfolded_snmf_pipeline_matches_jax(tmp_path, monkeypatch):
    """The DR-NMF experiment through the port's command line against
    ``drnmf_tpu.pipeline.run_unfolded_snmf``: equal config hashes and
    artifact names, best checkpoints, enhanced wavs and their SDR; a
    second invocation reuses every artifact; ``reporting`` on the port's
    folder agrees with the JAX package's on its own."""
    jdata_cfg, _, jexp = _experiment(tmp_path, "jax")
    _, tdata_yaml, texp = _experiment(tmp_path, "port")

    # the JAX dictionary, and initial values from it for both fits
    jds = jpipe.build_datasets(jdata_cfg)
    os.makedirs(os.path.join(jexp, "dicts"))
    w, _ = jpipe._dict_from_config(DRNMF, jdata_cfg, jds, jexp,
                                   os.path.join(jexp, "dicts") + "/",
                                   verbose=False)
    init = str(tmp_path / "init.npz")
    jcheckpoint.save_checkpoint(init, jdrnmf.init_drnmf_params(
        jpipe.drnmf_config_from_params(DRNMF, 129), w))
    model = {**DRNMF, "savefile_init": init}
    h = config_hash(model)
    assert h == jpipe.config_hash(model) == config_hash(
        {**model, "resume": True}, exclude=("resume", "fsdp"))

    jbest, jconfig, _ = jpipe.run_unfolded_snmf(
        model, jdata_cfg, jexp, flag_score=False, verbose=False)
    shutil.copytree(os.path.join(jexp, "dicts"), os.path.join(texp, "dicts"))
    model_yaml = _model_yaml(tmp_path, "unfolded_snmf", model)
    tbest, tconfig, results = _cli(model_yaml, tdata_yaml, texp)

    for sub in ("configs", "models", "history", "dicts"):
        assert sorted(os.listdir(os.path.join(texp, sub))) == \
            sorted(os.listdir(os.path.join(jexp, sub))), sub
    assert f"model_unfolded_snmf_{h}.npz" in os.listdir(
        os.path.join(texp, "models"))
    for k in jbest:
        np.testing.assert_allclose(tbest[k], np.asarray(jbest[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    saved, _ = jcheckpoint.load_checkpoint(
        os.path.join(texp, "models", f"model_unfolded_snmf_{h}.npz"))
    for k in tbest:
        np.testing.assert_array_equal(saved[k], tbest[k], err_msg=k)

    # the JAX package's wavs from its best checkpoint
    x, _, mask = jpipe.load_tensors(jds["valid"], jdata_cfg, None)
    irm = jpipe.predict_irm(lambda p, xb: jdrnmf.drnmf_apply(p, jconfig, xb),
                            jbest, x, mask_value=jconfig.mask_value)
    desc = f"unfolded_snmf_{h}_valid"
    jpipe.reconstruct_split(jds["valid"], irm, mask, desc)
    tds = tpipe.build_datasets(
        yaml.safe_load(open(tdata_yaml)), ("valid",), device="cpu")["valid"]
    _compare_wavs(jds["valid"], desc, tds)
    timer = results["timer"]
    assert [name for name, _, _ in timer.stages] == [
        "dictionary", "train", "load_tensors:valid", "predict_irm:valid",
        "reconstruct:valid"]
    # the split's audio counted once over its two stages
    assert timer.audio_seconds() == tpipe.dataset_audio_seconds(tds)
    np.testing.assert_allclose(
        timer.realtime_factor(), timer.audio_seconds() / (
            timer.seconds("predict_irm:valid")
            + timer.seconds("reconstruct:valid")))

    # a second invocation reuses every artifact
    model_file = os.path.join(texp, "models", f"model_unfolded_snmf_{h}.npz")
    before = open(model_file, "rb").read()

    def refuse(*args, **kwargs):
        raise AssertionError("the cached run trained")

    monkeypatch.setattr(tpipe, "train_model", refuse)
    monkeypatch.setattr(tpipe, "train_snmf", refuse)
    again, _, results2 = _cli(model_yaml, tdata_yaml, texp)
    assert open(model_file, "rb").read() == before
    for k in tbest:
        np.testing.assert_array_equal(again[k], tbest[k])
    assert [name for name, _, _ in results2["timer"].stages][1:] == [
        "load_tensors:valid", "predict_irm:valid", "reconstruct:valid"]

    # reporting on the folders the pipelines wrote
    rows, jrows = (treporting.summarize_experiment(texp),
                   jreporting.summarize_experiment(jexp))
    assert [r["model"] for r in rows] == [r["model"] for r in jrows] == \
        [f"unfolded_snmf_{h}"]
    np.testing.assert_allclose(rows[0]["val_loss"], jrows[0]["val_loss"],
                               rtol=1e-4)
    assert rows[0]["mean_sdr"] is None
    for keys in (None, ("log_D", "log_alph")):
        assert treporting.count_trainable_params(model_file, keys) == \
            jreporting.count_trainable_params(model_file, keys)
    hist = os.path.join(texp, "history", f"history_unfolded_snmf_{h}")
    for got, want in zip(treporting.learning_curve(hist),
                         jreporting.learning_curve(hist)):
        np.testing.assert_array_equal(got, want)
    table = [("DR-NMF", 2, 8, 100, 0.5, 9.25)]
    assert treporting.latex_table(table) == jreporting.latex_table(table)
    scores = str(tmp_path / "scores.npz")
    np.savez(scores, S=np.arange(12.0).reshape(4, 3))
    assert treporting.mean_scores_from_files([scores], 1) == \
        jreporting.mean_scores_from_files([scores], 1)

    # scored: the port's command line without --no-score against the JAX
    # package's scored run, each on its own folder and best checkpoint
    _, _, jres = jpipe.run_unfolded_snmf(model, jdata_cfg, jexp,
                                         flag_score=True, verbose=False,
                                         splits=("valid",))
    _, _, scored = _cli(model_yaml, tdata_yaml, texp, score=True)
    assert [name for name, _, _ in scored["timer"].stages][1:] == [
        "load_tensors:valid", "predict_irm:valid", "reconstruct:valid",
        "score:valid"]
    assert sorted(os.listdir(os.path.join(texp, "scores"))) == \
        sorted(os.listdir(os.path.join(jexp, "scores")))
    assert len(os.listdir(os.path.join(texp, "scores"))) == 6
    overall, want = scored["valid"][0].ravel(), jres["valid"][0].ravel()
    assert np.isfinite(overall).all()
    np.testing.assert_allclose(overall[:4], want[:4], rtol=0, atol=0.1)
    np.testing.assert_allclose(overall[4], want[4], rtol=0, atol=2e-3)
    np.testing.assert_allclose(overall[5], want[5], rtol=0, atol=1e-3)
    rows, jrows = (treporting.summarize_experiment(texp),
                   jreporting.summarize_experiment(jexp))
    assert abs(rows[0]["mean_sdr"] - jrows[0]["mean_sdr"]) <= 0.1

    # the cached scores are read back without scoring; --no-pesq writes
    # -1.0 for PESQ; --rescore recomputes the same values
    from drnmf_torch.metrics import engine, scoring
    for mod, name in ((scoring, "compute_scores"),
                      (engine, "score_all_packed")):
        monkeypatch.setattr(mod, name, refuse)
    _, _, again = _cli(model_yaml, tdata_yaml, texp, score=True)
    np.testing.assert_array_equal(again["valid"][0], scored["valid"][0])
    monkeypatch.undo()
    _, _, no_pesq = _cli(model_yaml, tdata_yaml, texp, "--rescore",
                         "--no-pesq", score=True)
    for (got, _), (full, _) in zip(no_pesq["valid"][1], scored["valid"][1]):
        assert np.all(got[:, 4] == -1.0)
        np.testing.assert_array_equal(got[:, [0, 1, 2, 3, 5]],
                                      full[:, [0, 1, 2, 3, 5]])
    _, _, rescored = _cli(model_yaml, tdata_yaml, texp, "--rescore",
                          score=True)
    np.testing.assert_array_equal(rescored["valid"][0], scored["valid"][0])

    # the general scorer on the port's wavs, one list (the engine's path,
    # P.862-style alignment), against the JAX package's scoring
    enh = [tds.enhanced_path(j, desc) for j in range(len(tds.y_wavfiles))]
    lists = {}
    for name, files in (("enh", enh), ("ref", list(tds.y_wavfiles))):
        lists[name] = str(tmp_path / f"{name}.txt")
        with open(lists[name], "w") as fh:
            fh.write("\n".join(files) + "\n")
    savefile = str(tmp_path / "score_audio.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "drnmf_torch.score_audio", "--enh",
         lists["enh"], "--ref", lists["ref"], "--savefile", savefile,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mean SDR" in proc.stdout
    got = np.load(savefile)
    assert str(got["align"]) == "full"
    want, _ = jscoring.score_taskfiles(enh, list(tds.y_wavfiles),
                                       align="full")
    for col, tol in enumerate((1e-3,) * 4 + (2e-3, 1e-3)):
        np.testing.assert_allclose(got["S"][:, col], want[:, col], rtol=0,
                                   atol=tol, err_msg=str(col))


def test_snmf_and_lstm_pipelines_match_jax(tmp_path, monkeypatch):
    """The 'snmf' and 'lstm' branches through the port's command line
    against the JAX package's at the same sizes: the SNMF enhancer from one
    dictionary, H from ones on both sides (the packages draw random
    initial H from other generators), its masks, validation loss and
    wavs; the LSTM from the JAX package's initial values, its best
    checkpoint and wavs."""
    jdata_cfg, _, jexp = _experiment(tmp_path, "jax")
    _, tdata_yaml, texp = _experiment(tmp_path, "port")
    jds = jpipe.build_datasets(jdata_cfg)
    tds = tpipe.build_datasets(yaml.safe_load(open(tdata_yaml)), ("valid",),
                               device="cpu")["valid"]
    x, y, mask = jpipe.load_tensors(jds["valid"], jdata_cfg, None)
    x_frames = jdata.masked_seqs_to_frames(x, mask)

    # snmf: the JAX run learns the dictionary; the port reuses it
    w, params_snmf, _ = jpipe.run_snmf(SNMF, jdata_cfg, jexp,
                                       flag_score=False, verbose=False)
    shutil.copytree(os.path.join(jexp, "dicts"), os.path.join(texp, "dicts"))
    ones = dataclasses.replace(params_snmf, init_h="ones")
    irm_frames, _ = jpipe.snmf_infer_irm(x_frames, w, ones, max_iter=30)
    infer = tpipe.snmf_infer_irm
    seen = []

    def infer_from_ones(x_f, w_f, params, **kw):
        out = infer(x_f, w_f, dataclasses.replace(params, init_h="ones"),
                    **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tpipe, "snmf_infer_irm", infer_from_ones)
    tw, _, _ = _cli(_model_yaml(tmp_path, "snmf", SNMF), tdata_yaml, texp)
    np.testing.assert_array_equal(tw, w)
    np.testing.assert_allclose(seen[0], irm_frames, rtol=2e-5, atol=1e-6)
    h = config_hash(SNMF)
    val = jreporting.best_val_loss(os.path.join(texp, "history",
                                                f"history_snmf_{h}"))
    y_frames = jdata.masked_seqs_to_frames(y, mask)
    np.testing.assert_allclose(
        val, np.mean((irm_frames * x_frames - y_frames) ** 2), rtol=1e-4)
    irm = np.zeros_like(x)
    fidx = jds["valid"].fidx
    for j in range(len(fidx)):
        irm[j, :fidx[j, 1] - fidx[j, 0]] = irm_frames[:, fidx[j, 0]:
                                                      fidx[j, 1]].T
    jpipe.reconstruct_split(jds["valid"], irm, mask, f"snmf_{h}_valid")
    _compare_wavs(jds["valid"], f"snmf_{h}_valid", tds)

    # lstm: both fits from the JAX package's initial values
    jcfg = jlstm.LSTMConfig(input_dim=129, hidden_dim=8, output_dim=129,
                            K_layers=2)
    init = {k: np.asarray(v) for k, v in jlstm.init_lstm_params(jcfg).items()}
    monkeypatch.setattr(tpipe, "init_lstm_params",
                        lambda config, device: params_from_numpy(init,
                                                                 device))
    jbest, _, _ = jpipe.run_lstm(LSTM, jdata_cfg, jexp, flag_score=False,
                                 verbose=False)
    tbest, _, _ = _cli(_model_yaml(tmp_path, "lstm", LSTM), tdata_yaml, texp)
    for k in jbest:
        np.testing.assert_allclose(tbest[k], np.asarray(jbest[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    h = config_hash(LSTM)
    irm = jpipe.predict_irm(lambda p, xb: jlstm.lstm_apply(p, jcfg, xb),
                            jbest, x)
    jpipe.reconstruct_split(jds["valid"], irm, mask, f"lstm_{h}_valid")
    _compare_wavs(jds["valid"], f"lstm_{h}_valid", tds, sdr=False)


def test_cli_dispatch_and_refusals(tmp_path, monkeypatch, capsys):
    """The model family from the config's file name ('unfolded_snmf'
    before 'snmf' before 'lstm'); scoring is the default, ``--no-score``,
    ``--no-pesq`` and ``--rescore`` reach the runner; missing files and
    unknown families are parser errors, before any work; ``--splits ''``
    trains without scoring or enhancing."""
    for name, family in (("params_unfolded_snmf_a.yaml", "unfolded_snmf"),
                         ("x/snmf_lstm.yaml", "snmf"),
                         ("my_lstm_5.yaml", "lstm")):
        assert tcli.dispatch_model_type(name) == family == \
            jcli.dispatch_model_type(name)
    with pytest.raises(ValueError, match="cannot infer model type"):
        tcli.dispatch_model_type("params_rnn.yaml")

    def refuse(*args, **kwargs):
        raise AssertionError("ran")

    calls = []
    monkeypatch.setattr(tpipe, "run_unfolded_snmf",
                        lambda *args, **kwargs: calls.append(kwargs))
    for runner in ("run_lstm", "run_snmf", "build_datasets"):
        monkeypatch.setattr(tpipe, runner, refuse)
    _, data_yaml, exp = _experiment(tmp_path, "port")
    model_yaml = _model_yaml(tmp_path, "unfolded_snmf", DRNMF)
    for extra, flags in (
            ((), (True, True, False)),
            (("--no-pesq", "--rescore"), (True, False, True)),
            (("--no-score", "--splits", "test"), (False, True, False))):
        tcli.main(["-c", model_yaml, "-d", data_yaml, "--device", "cpu",
                   *extra])
        kw = calls.pop()
        assert (kw["flag_score"], kw["compute_pesq"],
                kw["flag_rescore"]) == flags, extra
    for argv, message in (
            (["-c", "missing.yaml", "-d", data_yaml, "--device", "cpu"],
             "model config not found"),
            (["-c", _model_yaml(tmp_path, "rnn", DRNMF), "-d", data_yaml,
              "--device", "cpu"], "cannot infer model type")):
        with pytest.raises(SystemExit) as exc:
            tcli.main(argv)
        assert exc.value.code == 2
        assert message in capsys.readouterr().err, argv
    monkeypatch.undo()
    assert not os.path.exists(exp)  # no work before the runner

    # no splits: train only, no wav written
    best, _, results = tcli.main(["-c", model_yaml, "-d", data_yaml,
                                  "--exp-dir", exp, "--splits", "",
                                  "--device", "cpu", "-q"])
    assert [n for n, _, _ in results["timer"].stages] == ["dictionary",
                                                          "train"]
    audio = os.path.join(os.path.dirname(exp), "audio", "clean")
    assert sorted(os.listdir(audio)) == ["scaled"]
    assert set(best) >= {"log_D_0", "log_D_1", "log_alph_0", "log_h0"}
    assert not os.listdir(os.path.join(exp, "scores"))
