"""E-MAML-TRPO on HalfCheetah-RandDirec.

The port's entry point, with the DEFAULT_CONFIG and the CLI
(--config_file, --dump_path, --n_itr) of the JAX package's
run_scripts/e-maml_run_mujoco.py. It runs on the card; a config file with
"device": "cpu" runs it on the CPU. A run resumes from its snapshots
through promp_tpu_torch.utils.checkpoints.resume_trainer.
"""
import os
import sys

# Runnable straight from a checkout: a script's sys.path[0] is
# promp_tpu_torch/run_scripts/, so add the repo root, two levels up.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import argparse
import json
import time

from promp_tpu_torch.run import run_experiment

DEFAULT_CONFIG = {
    'seed': 1,
    'algo': 'TRPOMAML',
    'baseline': 'LinearFeatureBaseline',
    'env': 'HalfCheetahRandDirecEnv',
    'rollouts_per_meta_task': 20,
    'max_path_length': 100,
    'parallel': True,
    'discount': 0.99,
    'gae_lambda': 1,
    'normalize_adv': True,
    'hidden_sizes': (64, 64),
    'learn_std': True,
    'inner_lr': 0.1,
    'inner_type': 'log_likelihood',
    'step_size': 0.01,
    'exploration': True,
    'n_itr': 1001,
    'meta_batch_size': 40,
    'num_inner_grad_steps': 1,
}

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description='E-MAML-TRPO')
    parser.add_argument('--config_file', type=str, default='')
    parser.add_argument('--dump_path', type=str,
                        default=os.path.join(
                            ROOT, 'data', 'e-maml', f'run_{int(time.time())}'))
    parser.add_argument('--n_itr', type=int, default=None)
    args = parser.parse_args()
    if args.config_file:
        with open(args.config_file) as f:
            config = json.load(f)
    else:
        config = dict(DEFAULT_CONFIG)
    if args.n_itr is not None:
        config['n_itr'] = args.n_itr
    run_experiment(config, dump_path=args.dump_path)
