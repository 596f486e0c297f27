"""Object-style baselines (port of promp_tpu/ops/baseline_classes.py).

The processors call the functions of ``ops/baselines.py`` directly; these
classes give the reference's ``Baseline`` interface (fit, predict, get and
set the coefficients) over them. ``fit`` takes fixed-shape buffers:
observations (P, T, obs), timesteps (P, T), targets (P, T) and an optional
0/1 mask (P, T).
"""
from __future__ import annotations

import torch

from promp_tpu_torch.ops import baselines as ops


class Baseline:
    """The interface."""

    _coeffs = None

    def fit(self, observations, timesteps, targets, mask=None):
        raise NotImplementedError

    def predict(self, observations, timesteps):
        raise NotImplementedError

    def get_param_values(self, **tags):
        return self._coeffs

    def set_params(self, value, **tags):
        self._coeffs = value


class ZeroBaseline(Baseline):
    """Predicts zeros."""

    def fit(self, observations, timesteps, targets, mask=None):
        pass

    def predict(self, observations, timesteps):
        return torch.zeros(timesteps.shape, dtype=torch.float32,
                           device=timesteps.device)


class LinearFeatureBaseline(Baseline):
    """Ridge fit on [obs, obs^2, t/100, (t/100)^2, (t/100)^3, 1]."""

    def __init__(self, reg_coeff=1e-5):
        self._reg_coeff = reg_coeff
        self._coeffs = None

    def _features(self, observations, timesteps):
        return ops.feature_features(observations, timesteps)

    def fit(self, observations, timesteps, targets, mask=None):
        feats = self._features(observations, timesteps)
        self._coeffs = ops.fit_linear_baseline(
            feats.reshape(-1, feats.shape[-1]), targets.reshape(-1),
            mask=None if mask is None else mask.reshape(-1),
            reg_coeff=self._reg_coeff)

    def predict(self, observations, timesteps):
        if self._coeffs is None:
            return torch.zeros(timesteps.shape, dtype=torch.float32,
                               device=timesteps.device)
        return ops.predict_linear_baseline(
            self._features(observations, timesteps), self._coeffs)


class LinearTimeBaseline(LinearFeatureBaseline):
    """Time-only features [t/100, (t/100)^2, (t/100)^3, 1]."""

    def _features(self, observations, timesteps):
        return ops.time_features(timesteps)
