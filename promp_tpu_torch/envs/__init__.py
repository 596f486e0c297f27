"""Environments of the port; importing registers each in ENV_REGISTRY."""
from promp_tpu_torch.envs.base import ENV_REGISTRY, Box, TaskEnv, make_env, register_env  # noqa: F401
from promp_tpu_torch.envs.normalized import NormalizedEnv, normalize  # noqa: F401
from promp_tpu_torch.envs.point.corner import MetaPointEnvCorner  # noqa: F401
from promp_tpu_torch.envs.mujoco.locomotion import (  # noqa: F401
    HalfCheetahRandDirecEnv, HalfCheetahRandVelEnv)
