"""Config-driven experiment wiring of the run scripts (port of
promp_tpu/run.py).

``build`` makes env -> policy -> processor -> algo -> Trainer from a flat
config dict with the JAX package's keys and defaults (components chosen by
name); ``run_experiment`` configures the logger, dumps ``params.json`` and
trains. One key is the port's own: ``device``, the card (``"cuda"``)
unless the config asks for ``"cpu"``; without a card a CUDA run raises
before it writes anything. ``parallel`` is accepted and ignored, as in the
JAX package. The Trainer takes the scan rollout engine, as there.
"""
from __future__ import annotations

import json
import os

import numpy as np

from promp_tpu_torch.algos import DICEMAML, VPG_DICEMAML, ProMP, TRPOMAML, VPGMAML
from promp_tpu_torch.envs import make_env, normalize
from promp_tpu_torch.policies.gaussian_mlp import GaussianMLPPolicy
from promp_tpu_torch.sampling.dice_processor import DiceSampleProcessor
from promp_tpu_torch.sampling.processor import SampleProcessor
from promp_tpu_torch.trainer import Trainer
from promp_tpu_torch.utils import logger
from promp_tpu_torch.utils.misc import resolve_device

ALGOS = {
    "ProMP": ProMP,
    "TRPOMAML": TRPOMAML,
    "VPGMAML": VPGMAML,
    "DICEMAML": DICEMAML,
    "VPG_DICEMAML": VPG_DICEMAML,
}


class ClassEncoder(json.JSONEncoder):
    """Encodes classes and callables by name, and numpy arrays as lists, in
    params.json."""

    def default(self, o):
        if isinstance(o, type):
            return {"$class": o.__module__ + "." + o.__name__}
        if callable(o):
            return {"$function": getattr(o, "__name__", str(o))}
        if isinstance(o, np.ndarray):
            return o.tolist()
        return json.JSONEncoder.default(self, o)


def build(config):
    """The full stack from a config dict; returns the Trainer."""
    env = make_env(config["env"], **config.get("env_kwargs", {}))
    if config.get("normalize_env", True):
        env = normalize(env)

    policy = GaussianMLPPolicy(
        obs_dim=env.obs_dim,
        action_dim=env.action_dim,
        hidden_sizes=tuple(config.get("hidden_sizes", (64, 64))),
        learn_std=config.get("learn_std", True),
    )

    algo_name = config.get("algo", "ProMP")
    if algo_name in ("DICEMAML", "VPG_DICEMAML"):
        processor = DiceSampleProcessor(
            max_path_length=config.get("max_path_length", 100),
            discount=config.get("discount", 0.99),
            gae_lambda=config.get("gae_lambda", 1.0),
            normalize_adv=config.get("normalize_adv", True),
            positive_adv=config.get("positive_adv", False),
            baseline=config.get("baseline", "LinearTimeBaseline"),
            return_baseline=(config.get("return_baseline")
                             or ("LinearFeatureBaseline"
                                 if algo_name == "VPG_DICEMAML" else None)),
        )
    else:
        processor = SampleProcessor(
            discount=config.get("discount", 0.99),
            gae_lambda=config.get("gae_lambda", 1.0),
            normalize_adv=config.get("normalize_adv", True),
            positive_adv=config.get("positive_adv", False),
            baseline=config.get("baseline", "LinearFeatureBaseline"),
        )

    common = dict(
        policy=policy,
        inner_lr=config.get("inner_lr", 0.1),
        num_inner_grad_steps=config.get("num_inner_grad_steps", 1),
        trainable_inner_step_size=config.get("trainable_inner_step_size",
                                             False),
    )
    if algo_name == "ProMP":
        algo = ProMP(
            **common,
            learning_rate=config.get("learning_rate", 1e-3),
            num_ppo_steps=config.get("num_promp_steps", 5),
            clip_eps=config.get("clip_eps", 0.3),
            target_inner_step=config.get("target_inner_step", 0.01),
            init_inner_kl_penalty=config.get("init_inner_kl_penalty", 5e-4),
            adaptive_inner_kl_penalty=config.get("adaptive_inner_kl_penalty",
                                                 False),
            anneal_factor=config.get("anneal_factor", 1.0),
            outer_kl_limit=config.get("outer_kl_limit", 0.0),
        )
    elif algo_name == "TRPOMAML":
        algo = TRPOMAML(
            **common,
            step_size=config.get("step_size", 0.01),
            inner_type=config.get("inner_type", "likelihood_ratio"),
            exploration=config.get("exploration", False),
        )
    elif algo_name == "VPGMAML":
        algo = VPGMAML(
            **common,
            learning_rate=config.get("learning_rate", 1e-3),
            inner_type=config.get("inner_type", "likelihood_ratio"),
            exploration=config.get("exploration", False),
        )
    elif algo_name in ("DICEMAML", "VPG_DICEMAML"):
        algo = ALGOS[algo_name](
            **common,
            learning_rate=config.get("learning_rate", 1e-3),
        )
    else:
        raise KeyError(f"Unknown algo {algo_name!r}")

    if (config.get("n_devices") or 1) > 1:
        raise NotImplementedError(
            "n_devices > 1: the port runs on one card; task-axis sharding "
            "over several (parallel/mesh.py) is ROADMAP item 12")

    return Trainer(
        algo=algo,
        env=env,
        policy=policy,
        sample_processor=processor,
        meta_batch_size=config.get("meta_batch_size", 40),
        rollouts_per_meta_task=config.get("rollouts_per_meta_task", 20),
        max_path_length=config.get("max_path_length", 100),
        n_itr=config.get("n_itr", 1001),
        seed=config.get("seed", 1),
        fused=config.get("fused", False),
        timing_every=config.get("timing_every", 1),
        device=config.get("device", "cuda"),
    )


def run_experiment(config, dump_path=None):
    """Configure the logger, dump params.json, build and train; returns the
    final train_state."""
    resolve_device(config.get("device", "cuda"))
    logger.configure(
        dir=dump_path,
        format_strs=config.get("log_formats", ["stdout", "log", "csv"]),
        snapshot_mode=config.get("snapshot_mode", "last_gap"),
        snapshot_gap=config.get("snapshot_gap", 10),
    )
    with open(os.path.join(logger.get_dir(), "params.json"), "w") as f:
        json.dump(config, f, cls=ClassEncoder, indent=1)
    trainer = build(config)
    return trainer.train()
