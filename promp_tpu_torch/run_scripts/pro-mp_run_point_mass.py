"""ProMP on the 2D point-mass corner env.

The port's entry point, with the DEFAULT_CONFIG and the CLI
(--config_file, --dump_path, --n_itr) of the JAX package's
run_scripts/pro-mp_run_point_mass.py. It runs on the card; a config file with
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
    'algo': 'ProMP',
    'baseline': 'LinearFeatureBaseline',
    'env': 'MetaPointEnvCorner',
    'rollouts_per_meta_task': 20,
    'max_path_length': 100,
    'parallel': True,          # accepted for config compatibility; the
                               # rollout engine is always batched on device
    'discount': 0.99,
    'gae_lambda': 1,
    'normalize_adv': True,
    'hidden_sizes': (64, 64),
    'learn_std': True,
    'inner_lr': 0.1,
    'learning_rate': 1e-3,
    'num_promp_steps': 5,
    'clip_eps': 0.3,
    'target_inner_step': 0.01,
    'init_inner_kl_penalty': 5e-4,
    'adaptive_inner_kl_penalty': False,
    'n_itr': 1001,
    'meta_batch_size': 40,
    'num_inner_grad_steps': 1,
}

if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description='ProMP: Proximal Meta-Policy Search')
    parser.add_argument('--config_file', type=str, default='',
                        help='json file with run specifications')
    parser.add_argument('--dump_path', type=str,
                        default=os.path.join(
                            ROOT, 'data', 'pro-mp', f'run_{int(time.time())}'))
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
