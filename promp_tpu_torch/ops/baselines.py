"""Linear reward baselines by ridge regression (port of
promp_tpu/ops/baselines.py).

  * LinearFeatureBaseline features: [clip(obs,+-10), obs^2, t/100,
    (t/100)^2, (t/100)^3, 1]
  * LinearTimeBaseline features:    [t/100, (t/100)^2, (t/100)^3, 1]

The NaN -> reg*10 retry ladder is branchless: all candidate solves run as
one batched solve and the first finite one is selected on the device.
"""
from __future__ import annotations

import torch


def feature_features(obs, timesteps):
    """(..., T, obs_dim), (..., T) -> (..., T, 2*obs_dim + 4)."""
    o = torch.clamp(obs, -10.0, 10.0)
    t = timesteps[..., None].to(o.dtype) / 100.0
    return torch.cat([o, o ** 2, t, t ** 2, t ** 3, torch.ones_like(t)],
                     dim=-1)


def time_features(timesteps, dtype=torch.float32):
    t = timesteps[..., None].to(dtype) / 100.0
    return torch.cat([t, t ** 2, t ** 3, torch.ones_like(t)], dim=-1)


def fit_linear_baseline(feats, targets, mask=None, reg_coeff=1e-5,
                        n_retries=5):
    """Solve (F^T F + reg I) c = F^T y with the reg*10 retry ladder.

    Args:
        feats: (..., N, F) feature rows; leading axes are independent fits.
        targets: (..., N).
        mask: optional (..., N) 0/1 validity of each row.

    Returns:
        (..., F) coefficients: the first candidate, in order of rising reg,
        that is free of NaN and inf; the last candidate when none is.
    """
    if mask is not None:
        w = mask.to(feats.dtype)
        feats = feats * w[..., None]
        targets = targets * w
    gram = feats.transpose(-1, -2) @ feats
    rhs = (feats.transpose(-1, -2) @ targets[..., None])[..., 0]
    n_feat = gram.shape[-1]
    eye = torch.eye(n_feat, dtype=gram.dtype, device=gram.device)
    regs = reg_coeff * (10.0 ** torch.arange(
        n_retries, dtype=gram.dtype, device=gram.device))
    systems = gram[..., None, :, :] + regs[:, None, None] * eye
    rhs = rhs[..., None, :].expand(systems.shape[:-1])
    candidates, info = _solve(systems, rhs)
    ok = torch.isfinite(candidates).all(dim=-1) & (info == 0)
    first_ok = torch.argmax(ok.to(torch.int32), dim=-1)
    idx = torch.where(ok.any(dim=-1), first_ok,
                      torch.full_like(first_ok, n_retries - 1))
    return torch.gather(
        candidates, -2,
        idx[..., None, None].expand(idx.shape + (1, n_feat)))[..., 0, :]


def _solve(systems, rhs):
    """``torch.linalg.solve_ex`` of (..., F, F) systems: a singular system
    reports through ``info`` (and inf/NaN in its result) instead of
    raising, like an LU solve in XLA.

    On the CPU with more than one torch thread the systems are solved one
    at a time: torch's batched CPU solve (2.13.0+cpu, MKL) stalls there
    from about 200 unknowns (the ant's 230 features), printing SLASWP
    parameter errors. One thread keeps the batched call and its digits.
    """
    if systems.device.type != "cpu" or torch.get_num_threads() == 1:
        return torch.linalg.solve_ex(systems, rhs)
    n = systems.shape[-1]
    outs = [torch.linalg.solve_ex(a, b) for a, b in
            zip(systems.reshape(-1, n, n), rhs.reshape(-1, n))]
    return (torch.stack([x for x, _ in outs]).reshape(rhs.shape),
            torch.stack([i for _, i in outs]).reshape(rhs.shape[:-1]))


def predict_linear_baseline(feats, coeffs):
    """(..., N, F) @ (..., F) -> (..., N)."""
    return (feats @ coeffs[..., None])[..., 0]

