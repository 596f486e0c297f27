"""Hyperparameter sweep launcher (port of
promp_tpu/experiment_utils/run_sweep.py).

Modes over the cartesian product of the swept values:

  * ``serial``     every variant in this process, one after another
  * ``subprocess`` one fresh Python process per variant
  * ``list``       print each variant's config and dump path as JSON lines,
                   for an external scheduler
  * ``docker``     a Dockerfile (CUDA toolkit, g++, torch), per-variant
                   configs and a ``launch_docker.sh`` that builds the image
                   once and runs one container per variant on the card
                   with the data directory mounted
  * ``slurm``      one sbatch script per variant and ``submit_all.sh``

The scheduler modes generate launch files and submit nothing; submitting is
one ``bash launch_*.sh`` on a host that has the scheduler. Each variant
logs to ``<data_dir>/<exp_name>/<variant-slug>`` with its params.json. The
JAX package's ``gcloud-tpu`` mode launches TPU VMs, which the port does
not run on: it raises ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile

# the port's entry point the Docker image runs when given no command
DEFAULT_ENTRY = "promp_tpu_torch/run_scripts/pro-mp_run_point_mass.py"


def variant_dicts(sweep_params):
    """Cartesian product of sweep lists -> list of config dicts."""
    keys = list(sweep_params.keys())
    return [dict(zip(keys, values))
            for values in itertools.product(*[sweep_params[k] for k in keys])]


def _slug(variant):
    blob = json.dumps(variant, sort_keys=True, default=str)
    return hashlib.md5(blob.encode()).hexdigest()[:8]


_DOCKERFILE = f"""\
# Generated by promp_tpu_torch run_sweep (mode='docker'). Build context:
# the repo root. The kernels build with nvcc, the log and checkpoint
# writers with g++, at their first use inside the container.
FROM nvidia/cuda:12.4.1-devel-ubuntu22.04
RUN apt-get update && apt-get install -y --no-install-recommends \\
        python3 python3-pip g++ && rm -rf /var/lib/apt/lists/*
RUN pip3 install --no-cache-dir torch numpy
WORKDIR /repo
COPY . /repo
ENV PYTHONPATH=/repo
CMD ["python3", "{DEFAULT_ENTRY}"]
"""


def _write_script(path, text):
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, 0o755)
    return path


def _emit_scheduler_artifacts(mode, variants, exp_name, base_config,
                              data_dir, python_entry, slurm_opts=None,
                              image_tag=None):
    """Write ``<data_dir>/<exp_name>/launch/``: one config JSON per variant
    and the mode's launch script, whose path it returns. Submits
    nothing."""
    assert python_entry, f"{mode} mode needs python_entry"
    launch_dir = os.path.join(data_dir, exp_name, "launch")
    os.makedirs(launch_dir, exist_ok=True)
    entry_rel = os.path.relpath(python_entry)

    jobs = []  # (slug, config path)
    for variant in variants:
        config = dict(base_config or {})
        config.update(variant)
        slug = _slug(variant)
        cfg_path = os.path.join(launch_dir, f"config_{slug}.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f, indent=1, default=str)
        jobs.append((slug, cfg_path))

    if mode == "docker":
        # one image, one container per variant on the card, the data
        # directory mounted so results land on the host
        tag = image_tag or f"promp-torch-{exp_name}".lower()
        with open(os.path.join(launch_dir, "Dockerfile"), "w") as f:
            f.write(_DOCKERFILE)
        lines = ["#!/bin/bash", "set -eu",
                 'cd "$(dirname "$0")"',
                 f"docker build -f Dockerfile -t {tag} ../../..", ""]
        for slug, cfg in jobs:
            lines.append(
                f"docker run --rm --gpus all -v \"$(pwd)/../..:/data\" "
                f"{tag} \\\n"
                f"  python3 {entry_rel} --config_file "
                f"/data/launch/{os.path.basename(cfg)} "
                f"--dump_path /data/{slug}")
        return _write_script(os.path.join(launch_dir, "launch_docker.sh"),
                             "\n".join(lines) + "\n")

    if mode == "slurm":
        # one sbatch file per variant; slurm_opts adds directives, e.g.
        # {"partition": "gpu", "gres": "gpu:1", "time": "04:00:00"}
        opts = dict(slurm_opts or {})
        submit = ["#!/bin/bash", "set -eu", 'cd "$(dirname "$0")"']
        for slug, cfg in jobs:
            sb = ["#!/bin/bash",
                  f"#SBATCH --job-name={exp_name}-{slug}",
                  f"#SBATCH --output={slug}.slurm.out"]
            sb += [f"#SBATCH --{k}={v}" for k, v in sorted(opts.items())]
            sb += ["", f"python {entry_rel} "
                       f"--config_file {os.path.basename(cfg)} "
                       f"--dump_path ../{slug}"]
            _write_script(os.path.join(launch_dir, f"job_{slug}.sbatch"),
                          "\n".join(sb) + "\n")
            submit.append(f"sbatch job_{slug}.sbatch")
        return _write_script(os.path.join(launch_dir, "submit_all.sh"),
                             "\n".join(submit) + "\n")

    raise NotImplementedError(f"scheduler mode {mode!r}")


def run_sweep(run_experiment, sweep_params, exp_name, base_config=None,
              mode="serial", data_dir="data", python_entry=None,
              **scheduler_kwargs):
    """Run (or list, or generate launch files for) every variant of a
    sweep.

    Args:
        run_experiment: callable(config, dump_path), typically
            promp_tpu_torch.run.run_experiment.
        sweep_params: dict key -> list of values to sweep.
        exp_name: the sweep's name; variants log to
            ``<data_dir>/<exp_name>/<slug>``.
        base_config: config defaults under each variant.
        mode: 'serial' | 'subprocess' | 'list' | 'docker' | 'slurm' (the
            last two return the launch script's path).
        python_entry: the script of the subprocess and scheduler modes; it
            takes ``--config_file`` and ``--dump_path``, as every script in
            promp_tpu_torch/run_scripts/ does.
        **scheduler_kwargs: ``slurm_opts`` (dict of sbatch directives),
            ``image_tag`` (the docker image's tag).
    """
    if mode == "gcloud-tpu":
        raise NotImplementedError(
            "mode 'gcloud-tpu' launches TPU VMs; the port runs on CUDA "
            "cards: use 'docker' or 'slurm'")
    variants = variant_dicts(sweep_params)
    if mode in ("docker", "slurm"):
        return _emit_scheduler_artifacts(
            mode, variants, exp_name, base_config, data_dir, python_entry,
            **scheduler_kwargs)
    results = []
    for variant in variants:
        config = dict(base_config or {})
        config.update(variant)
        dump_path = os.path.join(data_dir, exp_name, _slug(variant))
        if mode == "list":
            print(json.dumps({"config": config, "dump_path": dump_path},
                             default=str))
        elif mode == "serial":
            results.append(run_experiment(config, dump_path=dump_path))
        elif mode == "subprocess":
            assert python_entry, "subprocess mode needs python_entry"
            with tempfile.NamedTemporaryFile(
                    "w", suffix=".json", delete=False) as f:
                json.dump(config, f, default=str)
                cfg_path = f.name
            try:
                subprocess.run(
                    [sys.executable, python_entry, "--config_file",
                     cfg_path, "--dump_path", dump_path], check=True)
            finally:
                os.unlink(cfg_path)
        else:
            raise NotImplementedError(f"sweep mode {mode!r}")
    return results
