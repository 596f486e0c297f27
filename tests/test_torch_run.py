"""The port's experiment wiring (promp_tpu_torch/run.py and
promp_tpu_torch/run_scripts/) against the JAX package's (promp_tpu/run.py,
run_scripts/), mirroring tests/test_run.py:

  * ``build`` of every algorithm against the JAX ``build`` of the same
    config: the classes, and every hyperparameter of the algorithm, the
    processor, the policy, the env and the Trainer (exact);
  * E-MAML's ``exploration`` flag, the DICE processors, the unknown algo's
    KeyError, ``n_devices``, and the card as the default device;
  * ``params.json`` of both packages loads to equal JSON; two builds of one
    config train to equal parameters (exact);
  * one ProMP meta-iteration at ``num_inner_grad_steps=2`` held against the
    JAX Trainer on the same pre-drawn tasks, resets and noise
    (test_torch_support.py: losses and KLs atol 1e-6 / rtol 1e-4,
    parameters atol 5e-6, float32);
  * the point-mass run script as a subprocess from a ``--config_file``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    check_parity, jax_phases, run_both, torch_single_thread)

import promp_tpu.run as jrun  # noqa: E402
import promp_tpu_torch.run as trun  # noqa: E402
from promp_tpu_torch.utils import logger  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = ("ProMP", "TRPOMAML", "VPGMAML", "DICEMAML", "VPG_DICEMAML")
TINY = {
    "seed": 0,
    "env": "MetaPointEnvCorner",
    "env_kwargs": {"reward_type": "dense"},
    "rollouts_per_meta_task": 2,
    "max_path_length": 5,
    "meta_batch_size": 2,
    "num_inner_grad_steps": 1,
    "hidden_sizes": (8, 8),
    "n_itr": 1,
    "snapshot_mode": "none",
    "log_formats": ["csv"],
    "device": "cpu",
}
# fields one package has and the other lacks, by component: the JAX
# policy's matmul precision and the JAX Trainer's mesh, against the port
# Trainer's device
JAX_ONLY = {"policy": {"precision"}, "trainer": {"mesh", "task_axis"}}
PORT_ONLY = {"trainer": {"device"}}


@pytest.fixture(autouse=True)
def _close_logger():
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
        logger.Logger.CURRENT = None


def _fields(obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in skip}


def _plain(v):
    """A field's value, with a dataclass (a Box) as its name and fields."""
    if dataclasses.is_dataclass(v):
        return type(v).__name__, {k: _plain(x) for k, x in _fields(v).items()}
    return v


def _check_component(name, got, want, skip=()):
    assert type(got).__name__ == type(want).__name__, name
    g, w = _fields(got, skip), _fields(want, skip)
    assert set(w) - set(g) == JAX_ONLY.get(name, set()), name
    assert set(g) - set(w) == PORT_ONLY.get(name, set()), name
    for k in set(g) & set(w):
        assert _plain(g[k]) == _plain(w[k]), \
            f"{name}.{k}: {g[k]!r} != {w[k]!r}"


def _check_build(config):
    t, j = trun.build(config), jrun.build(config)
    if type(j.env).__name__ == "NormalizedEnv":
        _check_component("env", t.env, j.env, skip=("env",))
        _check_component("inner env", t.env.env, j.env.env)
    else:
        _check_component("env", t.env, j.env)
    _check_component("policy", t.policy, j.policy)
    _check_component("processor", t.sample_processor, j.sample_processor)
    _check_component("algo", t.algo, j.algo, skip=("policy",))
    _check_component("trainer", t, j, skip=(
        "algo", "env", "policy", "sample_processor"))
    return t, j


CONFIGS = [dict(TINY, algo=a) for a in ALGOS] + [
    dict(TINY, algo="ProMP", num_promp_steps=3, clip_eps=0.2,
         adaptive_inner_kl_penalty=True, anneal_factor=0.9,
         target_inner_step=0.02, learning_rate=3e-4, outer_kl_limit=0.1,
         num_inner_grad_steps=2, trainable_inner_step_size=True,
         baseline="LinearTimeBaseline", discount=0.9, gae_lambda=0.95,
         normalize_adv=False, positive_adv=True, learn_std=False,
         hidden_sizes=[4], fused=True, timing_every=5, seed=9, n_itr=7),
    dict(TINY, algo="TRPOMAML", step_size=0.02, inner_type="log_likelihood",
         exploration=True, env="HalfCheetahRandVelEnv", env_kwargs={},
         normalize_env=False),
    dict(TINY, algo="VPG_DICEMAML", return_baseline="LinearTimeBaseline",
         baseline="LinearFeatureBaseline", max_path_length=7,
         env="MetaPointEnvWalls", env_kwargs={"reward_type": "sparse"}),
]


@pytest.mark.parametrize("config", CONFIGS,
                         ids=[f"{c['algo']}-{i}" for i, c in
                              enumerate(CONFIGS)])
def test_build_matches_jax(config):
    t, _ = _check_build(config)
    assert t.device.type == "cpu" and t.rollout_backend == "scan"


@pytest.mark.parametrize("algo", ["TRPOMAML", "VPGMAML"])
def test_emaml_exploration_flag(algo):
    trainer = trun.build(dict(TINY, algo=algo, exploration=True))
    assert trainer.algo.exploration
    state = trainer.train()
    assert all(bool(torch.isfinite(v).all()) for v in
               state["params"].values())


def test_dice_processors():
    from promp_tpu_torch.sampling.dice_processor import DiceSampleProcessor
    dice = trun.build(dict(TINY, algo="DICEMAML")).sample_processor
    vpg_dice = trun.build(dict(TINY, algo="VPG_DICEMAML")).sample_processor
    assert isinstance(dice, DiceSampleProcessor)
    assert (dice.baseline, dice.return_baseline) == ("LinearTimeBaseline",
                                                     None)
    assert vpg_dice.return_baseline == "LinearFeatureBaseline"
    assert type(trun.build(dict(TINY, algo="ProMP")).sample_processor) \
        .__name__ == "SampleProcessor"


def test_unknown_algo_rejected():
    with pytest.raises(KeyError):
        trun.build(dict(TINY, algo="NotAnAlgo"))


def test_n_devices():
    for n in (None, 0, 1):
        trun.build(dict(TINY, n_devices=n))
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        trun.build(dict(TINY, n_devices=2))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_is_the_card(tmp_path):
    config = {k: v for k, v in TINY.items() if k != "device"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.build(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run_experiment(config, dump_path=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()


def test_params_json_matches_jax(tmp_path, monkeypatch):
    config = dict(TINY, algo="ProMP", num_promp_steps=2,
                  extra={"nested": (1, 2), "arr": np.arange(3.0)},
                  reducer=np.mean)

    class _NoTrain:
        def train(self):
            return None

    # the JAX side only writes its params.json: no backend probe, no
    # compilation cache, no training
    monkeypatch.setattr(jrun, "build", lambda config: _NoTrain())
    monkeypatch.setattr(jrun, "ensure_backend", lambda: None)
    monkeypatch.setattr(jrun, "enable_compilation_cache", lambda: None)
    jrun.run_experiment(config, dump_path=str(tmp_path / "jax"))
    trun.run_experiment(config, dump_path=str(tmp_path / "torch"))
    want = json.load(open(tmp_path / "jax" / "params.json"))
    got = json.load(open(tmp_path / "torch" / "params.json"))
    assert got == want
    assert got["reducer"] == {"$function": "mean"}
    header = open(tmp_path / "torch" / "progress.csv").readline()
    for key in ("Itr", "n_timesteps", "Time-Sampling", "Time-OuterStep",
                "Step_1-AverageReturn"):
        assert key in header.strip().split(","), key


def test_config_determinism_across_builds():
    config = dict(TINY, algo="VPGMAML", seed=11, n_itr=2)
    s1 = trun.build(config).train()
    s2 = trun.build(config).train()
    for k in s1["params"]:
        assert torch.equal(s1["params"][k], s2["params"][k])


def test_two_inner_steps_match_jax(jax_phases):
    """BASELINE.json config 3's multi-step adaptation: ProMP with two inner
    steps, three sampling rounds, against the JAX Trainer."""
    result = run_both("scan", jax_phases, n_inner=2)
    check_parity(result, max_flips=0, n_inner=2)
    jm, _, tm, _, _, _ = result
    np.testing.assert_allclose(np.asarray(tm["inner_kls"]),
                               np.asarray(jm["inner_kls"]), atol=1e-6,
                               rtol=1e-4)
    assert np.asarray(tm["inner_kls"]).shape == (2,)


def _run_script(tmp_path, config):
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    dump = str(tmp_path / "out")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "promp_tpu_torch", "run_scripts",
                                      "pro-mp_run_point_mass.py"),
         "--config_file", cfg_path, "--dump_path", dump, "--n_itr", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    return proc, dump


def test_point_mass_script_subprocess(tmp_path):
    cfg = dict(TINY, algo="ProMP", num_promp_steps=2, snapshot_mode="all")
    cfg["hidden_sizes"] = list(cfg["hidden_sizes"])
    proc, dump = _run_script(tmp_path, cfg)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.load(open(os.path.join(dump, "params.json")))["n_itr"] == 2
    rows = open(os.path.join(dump, "progress.csv")).read().splitlines()
    assert len(rows) == 3
    assert sorted(f for f in os.listdir(dump) if f.endswith(".pkl")) == \
        ["itr_0.pkl", "itr_1.pkl"]
