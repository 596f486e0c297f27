"""The port stands alone: no module of promp_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib or promp_tpu (the card's machine has no
JAX)."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "promp_tpu")
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in
                 (ROOT / "promp_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_found():
    assert "promp_tpu_torch/trainer.py" in SOURCES
    assert "promp_tpu_torch/ops/rollout_kernel.py" in SOURCES
    for module in ("envs/mujoco/model.py", "envs/mujoco/spatial.py",
                   "envs/mujoco/engine.py", "envs/mujoco/locomotion.py",
                   "envs/mujoco/rand_params.py", "ops/substep_kernel.py",
                   "ops/substep_schedule.py", "ops/nvcc_build.py",
                   "envs/mujoco/rotations.py", "envs/mujoco/ant.py",
                   "envs/mujoco/humanoid.py", "optimizers/trpo.py",
                   "algos/vpg_maml.py", "algos/trpo_maml.py",
                   "algos/dice_maml.py", "sampling/dice_processor.py",
                   "run.py", "run_scripts/pro-mp_run_point_mass.py",
                   "run_scripts/pro-mp_run_mujoco.py",
                   "run_scripts/maml_run_mujoco.py",
                   "run_scripts/e-maml_run_mujoco.py",
                   "ops/baseline_classes.py", "utils/checkpoints.py",
                   "utils/native.py", "utils/logger.py", "utils/misc.py",
                   "experiment_utils/run_sweep.py", "envs/point/basic.py",
                   "envs/point/walls.py", "sampling/compat_sampler.py",
                   "sampling/render.py", "ops/smallsolve.py",
                   "envs/mujoco/scenes.py", "envs/sawyer.py"):
        assert f"promp_tpu_torch/{module}" in SOURCES, module


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_import(source):
    bad = [m for m in _imported_modules(ROOT / source)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{source} imports {bad}"
