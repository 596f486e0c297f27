"""The port's sweep launcher (promp_tpu_torch/experiment_utils/run_sweep.py)
against the JAX package's (promp_tpu/experiment_utils/run_sweep.py):
``variant_dicts``, the serial, list and subprocess modes, the docker and
slurm launch files (generated, never executed), and ``gcloud-tpu``
raising. Exact comparisons."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu.experiment_utils import run_sweep as jsweep  # noqa: E402
from promp_tpu_torch.experiment_utils import run_sweep as tsweep  # noqa: E402
from promp_tpu_torch.run import run_experiment  # noqa: E402
from promp_tpu_torch.utils import logger  # noqa: E402

ENTRY = "promp_tpu_torch/run_scripts/pro-mp_run_mujoco.py"
TINY = dict(env="MetaPointEnvCorner", env_kwargs={"reward_type": "dense"},
            rollouts_per_meta_task=2, max_path_length=4, meta_batch_size=2,
            hidden_sizes=[8], num_promp_steps=1, n_itr=1,
            snapshot_mode="none", log_formats=["csv"], device="cpu")


@pytest.mark.parametrize("sweep", [
    {"a": [1, 2, 3]},
    {"a": [1, 2], "b": [0.5], "c": ["x", "y", "z"]},
    {"seed": [1, 2], "env": ["MetaPointEnvCorner"], "empty": []},
])
def test_variant_dicts_match_jax(sweep):
    assert tsweep.variant_dicts(sweep) == jsweep.variant_dicts(sweep)


def test_serial_mode_runs_every_variant(tmp_path):
    calls = []

    def record(config, dump_path):
        calls.append((config, dump_path))
        return len(calls)

    # keys out of sorted order: the slug hashes them sorted, as JAX's does
    out = tsweep.run_sweep(record, {"seed": [1, 2], "lr": [0.1]}, "exp",
                           base_config={"n_itr": 1}, data_dir=str(tmp_path))
    assert out == [1, 2]
    assert [c["seed"] for c, _ in calls] == [1, 2]
    assert all(c["n_itr"] == 1 and c["lr"] == 0.1 for c, _ in calls)
    assert [os.path.basename(d) for _, d in calls] == \
        [jsweep._slug({"seed": 1, "lr": 0.1}),
         jsweep._slug({"seed": 2, "lr": 0.1})]


def test_serial_mode_trains_the_port(tmp_path):
    tsweep.run_sweep(run_experiment, {"seed": [0, 1]}, "pm",
                     base_config=TINY, data_dir=str(tmp_path))
    for seed in (0, 1):
        run = tmp_path / "pm" / tsweep._slug({"seed": seed})
        assert json.load(open(run / "params.json"))["seed"] == seed
        assert len(open(run / "progress.csv").read().splitlines()) == 2
    logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def test_list_mode_prints_configs(tmp_path, capsys):
    assert tsweep.run_sweep(None, {"a": [1, 2]}, "exp", base_config={"b": 3},
                            mode="list", data_dir=str(tmp_path)) == []
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["config"] for x in lines] == [{"b": 3, "a": 1},
                                            {"b": 3, "a": 2}]


def test_subprocess_mode(tmp_path):
    script = tmp_path / "entry.py"
    script.write_text(
        "import argparse, json, os\n"
        "p = argparse.ArgumentParser()\n"
        "p.add_argument('--config_file'); p.add_argument('--dump_path')\n"
        "a = p.parse_args()\n"
        "os.makedirs(a.dump_path)\n"
        "json.dump(json.load(open(a.config_file)),\n"
        "          open(os.path.join(a.dump_path, 'got.json'), 'w'))\n")
    tsweep.run_sweep(None, {"a": [1, 2]}, "exp", mode="subprocess",
                     data_dir=str(tmp_path), python_entry=str(script))
    for a in (1, 2):
        got = json.load(open(tmp_path / "exp" / tsweep._slug({"a": a})
                             / "got.json"))
        assert got == {"a": a}


def _read(path):
    assert os.access(path, os.X_OK), path
    return open(path).read()


def test_docker_mode_generates_files(tmp_path):
    script = tsweep.run_sweep(None, {"a": [1, 2]}, "exp",
                              base_config={"c": 9}, mode="docker",
                              data_dir=str(tmp_path), python_entry=ENTRY)
    launch = os.path.dirname(script)
    text = _read(script)
    assert text.count("docker run --rm --gpus all") == 2
    assert "docker build" in text and ENTRY in text
    dockerfile = open(os.path.join(launch, "Dockerfile")).read()
    assert "torch" in dockerfile and "jax" not in dockerfile
    assert "nvidia/cuda" in dockerfile and "g++" in dockerfile
    assert tsweep.DEFAULT_ENTRY in dockerfile
    # the same per-variant configs as the JAX package's
    jlaunch = os.path.dirname(jsweep.run_sweep(
        None, {"a": [1, 2]}, "exp", base_config={"c": 9}, mode="docker",
        data_dir=str(tmp_path / "jax"), python_entry=ENTRY))
    cfgs = sorted(f for f in os.listdir(launch) if f.startswith("config_"))
    assert cfgs == sorted(f for f in os.listdir(jlaunch)
                          if f.startswith("config_"))
    for f in cfgs:
        assert open(os.path.join(launch, f)).read() == \
            open(os.path.join(jlaunch, f)).read()


def test_slurm_mode_matches_jax(tmp_path):
    kw = dict(mode="slurm", python_entry=ENTRY,
              slurm_opts={"partition": "gpu", "gres": "gpu:1"})
    script = tsweep.run_sweep(None, {"a": [1, 2, 3]}, "exp",
                              data_dir=str(tmp_path / "t"), **kw)
    jscript = jsweep.run_sweep(None, {"a": [1, 2, 3]}, "exp",
                               data_dir=str(tmp_path / "j"), **kw)
    launch, jlaunch = os.path.dirname(script), os.path.dirname(jscript)
    assert sorted(os.listdir(launch)) == sorted(os.listdir(jlaunch))
    assert _read(script) == _read(jscript)
    jobs = sorted(f for f in os.listdir(launch) if f.endswith(".sbatch"))
    assert len(jobs) == 3
    for job in jobs:
        body = _read(os.path.join(launch, job))
        assert body == open(os.path.join(jlaunch, job)).read()
        assert "#SBATCH --gres=gpu:1" in body and ENTRY in body


def test_gcloud_tpu_mode_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="gcloud-tpu"):
        tsweep.run_sweep(None, {"a": [1]}, "exp", mode="gcloud-tpu",
                         data_dir=str(tmp_path), python_entry=ENTRY)
    assert not os.listdir(tmp_path)


def test_unknown_mode_raises(tmp_path):
    with pytest.raises(NotImplementedError):
        tsweep.run_sweep(None, {"a": [1]}, "exp", mode="ec2",
                         data_dir=str(tmp_path))
