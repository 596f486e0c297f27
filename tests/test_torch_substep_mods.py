"""K3's plain version (promp_tpu_torch.ops.substep_kernel with
``mod_keys``) against the TPU kernel
promp_tpu.ops.pallas_substep.make_pallas_chain with ``mod_keys`` in
interpret mode, on walker2d, hopper and half_cheetah at 5 substeps and
B = 6 seeded states, each env with its own multipliers (drawn in the
ranges of ``sample_param_multipliers`` and packed by the JAX package's
``_pack_mods``, handed to both unchanged); the K3 route of ``Engine.step``; and the C
source that K3 is built from.

Tolerances: q rtol 1e-5 / atol 1e-6, qd rtol 1e-4 / atol 1e-4, as K2's
(tests/test_torch_spatial.py): both run the same emitted algebra with the
same constant folding and operation order, the multipliers entering as
plain products in both. The states are test_torch_spatial.py's ``_batch``
draws about the model's initial pose. (``_batch`` alone puts the walker's
and the hopper's root 1.25 below its rest height, their q[1] being the
height slide, deep in the ground: there |qd| reaches 200 and even K2's
plain version, without mods, leaves JAX by twice these bars after one
substep, an ulp of cos/sin amplified by the penalty contacts. About the
initial pose, where the envs run, the hopper's gaps are 3e-8 on q and
1.9e-6 on qd over 5 substeps.) The walker is held at the JAX package's own
K3 bars, q rtol 1e-4 / atol 1e-5 and qd rtol 1e-3 / atol 1e-3
(tests/test_pallas_substep.py:146-169): with random velocities its
contacts amplify those ulps to 2.2e-4 on qd (1.1e-6 on q) at these
states, the same order with and without mods (K2's plain version leaves
the tight bars there too).
"""
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_spatial import (  # noqa: E402,F401
    _batch, check_staged_source, pinned)
from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu.envs.mujoco.engine import Engine as JEngine  # noqa: E402
from promp_tpu.envs.mujoco.model import get_model as jget_model  # noqa: E402
from promp_tpu.ops.pallas_substep import _pack_mods, make_pallas_chain  # noqa: E402
from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402
from promp_tpu_torch.envs.mujoco.model import get_model  # noqa: E402
from promp_tpu_torch.ops import substep_kernel as sk  # noqa: E402

N_STEPS, B = 5, 6
KEYS = ("body_inertia", "body_mass", "dof_damping", "friction")
NM = {"walker2d": 38, "hopper": 23, "half_cheetah": 38}
Q_TOL = dict(rtol=1e-5, atol=1e-6)
QD_TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX package's K3 bars, for the walker (see above)
JAX_TOL = (dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-3))
TOL = {"walker2d": JAX_TOL, "hopper": (Q_TOL, QD_TOL),
       "half_cheetah": (Q_TOL, QD_TOL)}


@functools.lru_cache(maxsize=None)
def _source(name, keys=()):
    """The emitted source of ``name``'s K2, or K3 with ``keys``, built once
    a module."""
    return sk.SubstepSource(Engine(get_model(name)), keys)


def _states(model, seed, n=B):
    """(q, qd, tau): ``_batch``'s draws about the model's initial pose."""
    q, qd, tau = _batch(model.nv, seed, n=n)
    return q + model.init_qpos.astype(np.float32), qd, tau


def _inputs(name, seed):
    """(q, qd, tau) of B seeded states, and the JAX-packed (B, nm) mods of
    B different tasks with the multiplier dict they were packed from, as
    numpy arrays. The multipliers follow ``sample_param_multipliers``'
    ranges, drawn with numpy (an eager JAX draw compiles a program a
    key)."""
    m = jget_model(name)
    rng = np.random.default_rng(seed)
    shapes = {"body_inertia": (1.5, (B, m.nb, 3)),
              "body_mass": (1.5, (B, m.nb)),
              "dof_damping": (1.3, (B, m.nv)), "friction": (1.5, (B,))}
    mods = {k: (base ** rng.uniform(-3.0, 3.0, shape)).astype(np.float32)
            for k, (base, shape) in shapes.items()}
    return _states(m, seed) + (np.asarray(_pack_mods(m, KEYS, mods)), mods)


@pytest.mark.parametrize("name", ["walker2d", "hopper", "half_cheetah"])
def test_plain_chain_matches_pallas_kernel_with_mods(name):
    q, qd, tau, packed, mods = _inputs(name, 7)
    assert packed.shape == (B, NM[name])
    # every env has its own multipliers, so a wrong row stride would show
    assert len({tuple(r) for r in packed}) == B
    chain = make_pallas_chain(JEngine(jget_model(name)), N_STEPS, tile=128,
                              interpret=True, mod_keys=KEYS)
    qj, qdj = (np.asarray(a) for a in chain(q, qd, tau, packed))
    engine = Engine(get_model(name))
    # the port packs the JAX dict into the same array
    tpacked = sk.pack_mods(engine.model, KEYS, {
        k: torch.tensor(v) for k, v in mods.items()}, (B,))
    assert torch.equal(tpacked, torch.tensor(packed))
    probe = []
    qp, qdp = sk.substep_chain_plain(engine, N_STEPS, KEYS)(
        torch.tensor(q), torch.tensor(qd), torch.tensor(tau), tpacked, probe)
    assert np.isfinite(qj).all() and np.isfinite(qdj).all()
    q_tol, qd_tol = TOL[name]
    np.testing.assert_allclose(qp.numpy(), qj, **q_tol)
    np.testing.assert_allclose(qdp.numpy(), qdj, **qd_tol)
    # the contacts act
    assert len(probe) == len(engine.model.con_body) * N_STEPS
    assert float(sum(p.sum() for p in probe)) > 0
    # and the multipliers matter: the unmodded chain lands elsewhere
    q0, qd0 = sk.substep_chain_plain(engine, N_STEPS)(
        torch.tensor(q), torch.tensor(qd), torch.tensor(tau))
    assert float((qd0 - qdp).abs().max()) > 1e-2


def test_task_axis_mods_broadcast_over_envs_through_engine_step():
    engine = Engine(get_model("hopper"))
    m = engine.model
    n_t, n_e = 2, 3
    q, qd, _ = (torch.tensor(a).reshape(n_t, n_e, m.nv)
                for a in _states(m, 4, n=n_t * n_e))
    ctrl = torch.tensor(np.random.default_rng(4).uniform(
        -1, 1, (n_t, n_e, m.nu)).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    mods = {"body_inertia": 1 + torch.rand((n_t, m.nb, 3), generator=gen),
            "body_mass": 1 + torch.rand((n_t, m.nb), generator=gen),
            "dof_damping": 1 + torch.rand((n_t, m.nv), generator=gen),
            "friction": 1 + torch.rand((n_t,), generator=gen)}
    # the rollout's form: task-axis views expanded over the envs
    views = {k: v[:, None].expand((n_t, n_e) + v.shape[1:])
             for k, v in mods.items()}
    assert views["body_mass"].stride(1) == 0
    repeated = {k: v.repeat_interleave(n_e, 0).reshape(
        (n_t, n_e) + v.shape[1:]) for k, v in mods.items()}
    got = engine.step(q, qd, ctrl, 4, views)
    want = engine.step(q, qd, ctrl, 4, repeated)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a (tasks, 1) batch broadcasts too
    single = {k: v[:, None] for k, v in mods.items()}
    assert all(torch.equal(a, b) for a, b in zip(
        engine.step(q, qd, ctrl, 4, single), want))
    assert got[0].shape == (n_t, n_e, m.nv)
    assert set(engine._chain_cache) == {(4, KEYS)}


def test_step_without_mods_keeps_k2s_route():
    engine = Engine(get_model("walker2d"))
    m = engine.model
    q, qd, _ = (torch.tensor(a) for a in _states(m, 5, n=4))
    ctrl = torch.tensor(np.random.default_rng(5).uniform(
        -1, 1, (4, m.nu)).astype(np.float32))
    sk.substep_chain.launches = sk.substep_chain.mods_launches = 0
    got = engine.step(q, qd, ctrl, 8)
    assert set(engine._chain_cache) == {(8, ())}
    want = sk.substep_chain_plain(engine, 8)(q, qd, engine.actuation(ctrl))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # multipliers of one are the same physics up to where K2 folds the
    # constants in float64 and K3 multiplies in float32
    ones = {k: torch.ones((4,) + s) for k, s in (
        ("body_inertia", (m.nb, 3)), ("body_mass", (m.nb,)),
        ("dof_damping", (m.nv,)), ("friction", ()))}
    q1, qd1 = engine.step(q, qd, ctrl, 8, ones)
    assert set(engine._chain_cache) == {(8, ()), (8, KEYS)}
    np.testing.assert_allclose(q1.numpy(), got[0].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(qd1.numpy(), got[1].numpy(), rtol=1e-3,
                               atol=1e-3)
    # on the CPU no kernel is launched
    assert sk.substep_chain.launches == sk.substep_chain.mods_launches == 0


def test_unsupported_mod_keys_raise():
    engine = Engine(get_model("hopper"))
    with pytest.raises(NotImplementedError, match="'geom_friction'"):
        sk.substep_chain(engine, 4, ("body_mass", "geom_friction"))
    with pytest.raises(NotImplementedError, match="'hopper'.*'gravity'"):
        engine.step(torch.zeros((1, 6)), torch.zeros((1, 6)),
                    torch.zeros((1, 3)), 4,
                    {"body_mass": torch.ones((1, 4)),
                     "gravity": torch.ones((1,))})


def test_wrapper_rejects_bad_mods():
    engine = Engine(get_model("hopper"))
    chain = sk.substep_chain(engine, 4, KEYS)
    q = torch.zeros((3, 6))
    with pytest.raises(ValueError, match="mods_packed.*expected \\(B, 23\\)"):
        chain(q, q, q, torch.ones((3, 22)))
    with pytest.raises(ValueError, match="mods_packed.*expected \\(B, 23\\)"):
        chain(q, q, q, torch.ones((2, 23)))
    with pytest.raises(ValueError, match="mods_packed is torch.float64"):
        chain(q, q, q, torch.ones((3, 23), dtype=torch.float64))
    with pytest.raises(ValueError, match="mods_packed is not contiguous"):
        chain(q, q, q, torch.ones((23, 3)).t())
    with pytest.raises(ValueError, match="several devices"):
        chain(q, q, q, torch.ones((3, 23), device="meta"))
    with pytest.raises(ValueError, match="4 values an env"):
        sk.pack_mods(engine.model, ("body_mass",),
                     {"body_mass": torch.ones((3, 5))}, (3,))


@pytest.mark.parametrize("name", ["walker2d", "hopper", "half_cheetah"])
def test_k3_source_reads_the_mods_row(name):
    engine = Engine(get_model(name))
    src = _source(name, KEYS)
    assert src.nm == NM[name] == sk.n_mods(engine.model, KEYS)
    text = src.text
    assert "/*@" not in text and f"constexpr int kNm = {src.nm};" in text
    assert text.count("__global__") == 1
    assert 'extern "C" int substep_chain_launch' in text
    # every mass, damping and friction multiplier is read in the body, and
    # the inertias' where the body's rotation does not fold them away (a
    # planar body's off-plane inertia is dead, in JAX too)
    m = engine.model
    used = {int(i) for i in re.findall(r"\bm\[(\d+)\]", text)}
    assert set(range(3 * m.nb, src.nm)) <= used <= set(range(src.nm))
    assert {i // 3 for i in used if i < 3 * m.nb} == set(range(m.nb))
    k2 = _source(name)
    assert src.n_ops > k2.n_ops


def test_k2_body_unchanged_without_mods():
    """Without mods K2's emitted half_cheetah body keeps its 3,729 live
    operations and reads no multiplier."""
    src = _source("half_cheetah")
    assert src.n_ops == 3729
    assert "m[" not in src.text and "constexpr int kNm = 0;" in src.text


def test_k3_source_compiled_for_the_host(pinned, tmp_path):
    """K3's scheduled walker2d source built for the host and run stage by
    stage (tests/test_torch_spatial.py ``staged_host_chain``), held
    bitwise against the plain version at B = 37 with per-env multipliers
    and a NaN row."""
    engine = Engine(get_model("walker2d"))
    q, qd, tau = _states(engine.model, 3, n=37)
    packed = np.ascontiguousarray(1.5 ** np.random.default_rng(3).uniform(
        -3, 3, (37, 38)).astype(np.float32))
    check_staged_source(_source("walker2d", KEYS),
                        sk.substep_chain_plain(engine, N_STEPS, KEYS), q, qd,
                        tau, packed, tmp_path)
