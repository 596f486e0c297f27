"""The port's generic engine (envs/mujoco/engine.py's generic route,
ops/smallsolve.py, ChainModel.dof_ancestor_strict and the Sawyer scenes)
against the JAX package.

The JAX solves run eagerly under ``jax.vmap``; the engine's terms and
steps are jitted once per model and dtype. The pick-and-place scene is
the push scene (held field by field), so the terms and steps take the
swimmer, push and door. In
float64 (``jax.enable_x64`` and a float64 JAX Engine) the two packages
compute the same formulas in the same order, so the bars are 1e-12 for
a well-conditioned solve and the terms, 1e-4 of their scale for the
ill-conditioned and clamped solves (cond * eps bounds the gap), and
1e-9 for an env step (4-5 substeps through contacts); in float32 an env
step is held at the JAX package's own bars for two formulations of one
physics (q rtol 1e-4 / atol 1e-5, qd 1e-3 / 1e-3, tests/test_spatial.py).
The humanoid's generic path is not compiled here (its JAX program is the
slowest of tests/test_engine.py); the column solve is held at its size
(n = 23) directly instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.envs.mujoco import scenes as jscenes  # noqa: E402
from promp_tpu.envs.mujoco.engine import Engine as JEngine  # noqa: E402
from promp_tpu.envs.mujoco.model import get_model as jget_model  # noqa: E402
from promp_tpu.ops import smallsolve as jsolve  # noqa: E402
from promp_tpu_torch.envs.mujoco import scenes as tscenes  # noqa: E402
from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402
from promp_tpu_torch.envs.mujoco.model import get_model  # noqa: E402
from promp_tpu_torch.ops import smallsolve as tsolve  # noqa: E402
from promp_tpu_torch.ops import substep_kernel as sk  # noqa: E402

Q_TOL, QD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-3, atol=1e-3)
SCENES = ("swimmer", "sawyer_push", "sawyer_door")
B = 4


def _models(name):
    """(JAX model, port model) of a spec or a Sawyer scene."""
    if name.startswith("sawyer"):
        kind = name.split("_")[1]
        return (getattr(jscenes, f"sawyer_{kind}_model")(),
                getattr(tscenes, f"sawyer_{kind}_model")())
    return jget_model(name), get_model(name)


def _jengine(model, x64):
    return JEngine(model, dtype=jnp.float64 if x64 else jnp.float32,
                   use_planar=False, use_spatial=False,
                   use_pallas_substep=False)


def _states(model, seed, n=B):
    """Random (q, qd, ctrl) around the initial pose, float64 numpy."""
    rng = np.random.default_rng(seed)
    q = model.init_qpos + 0.2 * rng.standard_normal((n, model.nv))
    qd = rng.standard_normal((n, model.nv))
    ctrl = rng.uniform(-1.5, 1.5, (n, model.nu))
    return q, qd, ctrl


def _pair(x, x64):
    """(JAX array, port tensor) of one numpy array in the test's dtype."""
    return (jnp.asarray(x, jnp.float64 if x64 else jnp.float32),
            torch.tensor(x, dtype=torch.float64 if x64 else torch.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


# ------------------------------------------------------------- smallsolve
def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.geomspace(1.0, 1.0 / cond, n)
    return (Q * eig) @ Q.T, rng.standard_normal(n)


def _systems(n, seed):
    """A batch of 3: well conditioned, ill conditioned (1e14), and a
    semidefinite one (rank n - 2, its pivots clamped)."""
    A0, b0 = _spd(n, seed)
    A1, b1 = _spd(n, seed + 1, cond=1e14)
    rng = np.random.default_rng(seed + 2)
    G = rng.standard_normal((n, max(n - 2, 1)))
    A2, b2 = G @ G.T, rng.standard_normal(n)
    return np.stack([A0, A1, A2]), np.stack([b0, b1, b2])


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("solver,n", [("chol_solve_unrolled", 1),
                                      ("chol_solve_unrolled", 6),
                                      ("chol_solve_unrolled", 16),
                                      ("chol_solve_cols", 5),
                                      ("chol_solve_cols", 14),
                                      ("chol_solve_cols", 23)])
def test_solves_match_jax(solver, n, x64):
    A, b = _systems(n, n)
    with jax.enable_x64(x64):
        (jA, tA), (jb, tb) = _pair(A, x64), _pair(b, x64)
        want = jax.vmap(getattr(jsolve, solver))(jA, jb)
        got = getattr(tsolve, solver)(tA, tb)
    assert got.dtype == tA.dtype
    # float32 cannot hold the cond-1e14 and clamped systems' solutions
    assert torch.isfinite(got if x64 else got[0]).all()
    want = np.asarray(want)
    # the same pivots, clamps and substitutions in the same order; the
    # well-conditioned system (cond 1e3) agrees to its rounding
    scale = np.abs(want[0]).max()
    _close(got[0], want[0], rtol=0, atol=(1e-12 if x64 else 1e-4) * scale)
    if x64:
        # the ill-conditioned (cond 1e14) and clamped systems amplify one
        # rounding by up to cond * eps (1e-2 of their scale); the gaps seen
        # are below 4e-6 of it
        for i in (1, 2):
            _close(got[i], want[i], rtol=0,
                   atol=1e-4 * np.abs(want[i]).max())
    # the well-conditioned system is solved
    x = got[0].double().numpy()
    np.testing.assert_allclose(A[0] @ x, b[0], atol=1e-10 if x64 else 1e-3)


@pytest.mark.parametrize("n", [2, 6, 23])
def test_clamped_pivot_count_matches_jax(n):
    A, _ = _systems(n, 7 * n)
    with jax.enable_x64():
        jA, tA = _pair(A, True)
        want = np.asarray(jax.vmap(jsolve.clamped_pivot_count)(jA))
        got = tsolve.clamped_pivot_count(tA)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the healthy system clamps nothing; the rank-deficient one clamps
    assert got[0] == 0 and (n < 3 or got[2] >= 1)


def test_batched_solves_take_any_leading_shape():
    A, b = _systems(5, 3)
    tA, tb = torch.tensor(A), torch.tensor(b)
    flat = tsolve.chol_solve_cols(tA, tb)
    got = tsolve.chol_solve_cols(tA[None].expand(2, 3, 5, 5),
                                 tb[None].expand(2, 3, 5))
    assert got.shape == (2, 3, 5) and torch.equal(got[1], flat)
    assert torch.equal(tsolve.chol_solve_unrolled(tA[:1], tb[:1]),
                       tsolve.chol_solve_unrolled(tA, tb)[:1])


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("name", ("swimmer", "ant", "humanoid", "sawyer_door"))
def test_dof_ancestor_strict_matches_jax(name):
    jm, tm = _models(name)
    want = jm.dof_ancestor_strict()
    got = tm.dof_ancestor_strict()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got is tm.dof_ancestor_strict() and not got.flags.writeable


@pytest.mark.parametrize("name", ("sawyer_push", "sawyer_door",
                                  "sawyer_pick"))
def test_scenes_match_jax_field_by_field(name):
    jm, tm = _models(name)
    for field in jm.__dataclass_fields__:
        a, b = getattr(tm, field), getattr(jm, field)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), field
        else:
            assert a == b, field
    assert tm.name == name


# ------------------------------------------------------- generic terms
@pytest.fixture(scope="module", params=SCENES)
def terms(request):
    """The generic terms of one model on B random states, float64, from
    both packages."""
    jm, tm = _models(request.param)
    q, qd, _ = _states(tm, 5)
    with jax.enable_x64():
        je = _jengine(jm, True)
        jq, tq = _pair(q, True)
        jqd, tqd = _pair(qd, True)

        def all_terms(q, qd):
            out = dict(M=je.mass_matrix(q), rnea=je.rnea_bias(q, qd),
                       fluid=je.fluid_torque(q, qd),
                       limit=je._limit_terms(q, qd))
            if len(jm.pair_a):
                out["pair"] = je._pair_terms(q, qd)
            return out

        want = jax.tree.map(np.asarray,
                            jax.jit(jax.vmap(all_terms))(jq, jqd))
    te = Engine(tm)
    got = dict(M=te.mass_matrix(tq), rnea=te.rnea_bias(tq, tqd),
               fluid=te.fluid_torque(tq, tqd), limit=te._limit_terms(tq, tqd))
    if len(tm.pair_a):
        got["pair"] = te._pair_terms(tq, tqd)
    return request.param, te, tq, tqd, got, want


def test_terms_match_jax(terms):
    name, _, _, _, got, want = terms
    assert set(got) == set(want)
    for key in ("M", "rnea", "fluid"):
        _close(got[key], want[key], rtol=1e-12, atol=1e-12, err_msg=key)
    for g, w in zip(got["limit"], want["limit"]):
        _close(g, w, rtol=1e-12, atol=1e-12)
    if "pair" in got:
        for g, w in zip(got["pair"], want["pair"]):
            _close(g, w, rtol=1e-12, atol=1e-12)
    if name == "swimmer":
        assert np.abs(want["fluid"]).max() > 1e-3   # the medium acts


def test_rnea_equals_the_autodiff_oracle(terms):
    _, te, tq, tqd, got, _ = terms
    oracle = -(te._bias_torque(tq, tqd) + te.gravity_torque(tq))
    np.testing.assert_allclose(got["rnea"].numpy(), oracle.numpy(),
                               rtol=1e-9, atol=1e-9)


def test_mass_matrix_is_symmetric_positive_definite(terms):
    _, _, _, _, got, _ = terms
    M = got["M"]
    assert torch.allclose(M, M.transpose(-1, -2), atol=1e-12)
    assert (torch.linalg.eigvalsh(M) > 0).all()


def test_pair_terms_push_when_the_spheres_overlap():
    """The push scene with the EE sphere pressed into the puck: a normal
    force along the centre line and an active implicit stiffness."""
    jm, tm = _models("sawyer_push")
    q = np.array([[0.0, 0.6, 0.04, 0.05, 0.6, 0.04]])   # 0.05 apart, r 0.07
    qd = np.zeros_like(q)
    qd[0, 0] = 0.3
    with jax.enable_x64():
        je = _jengine(jm, True)
        want = jax.tree.map(np.asarray, jax.jit(jax.vmap(je._pair_terms))(
            jnp.asarray(q), jnp.asarray(qd)))
    got = Engine(tm)._pair_terms(torch.tensor(q), torch.tensor(qd))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-12, atol=1e-12)
    tau, _, _, K = got
    assert tau[0, 0] < 0 < tau[0, 3] and K.abs().max() > 0


# ------------------------------------------------------------ env steps
@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("name", SCENES)
def test_engine_step_matches_jax(name, x64):
    jm, tm = _models(name)
    q, qd, ctrl = _states(tm, 11)
    frame_skip = 4
    with jax.enable_x64(x64):
        je = _jengine(jm, x64)
        (jq, tq), (jqd, tqd), (jc, tc) = (_pair(x, x64) for x in (q, qd,
                                                                  ctrl))
        wq, wqd = jax.jit(jax.vmap(
            lambda a, b, c: je.step(a, b, c, frame_skip)))(jq, jqd, jc)
    before = Engine.generic_substeps
    gq, gqd = Engine(tm).step(tq, tqd, tc, frame_skip)
    assert Engine.generic_substeps - before == frame_skip
    assert gq.dtype == tq.dtype
    if x64:
        _close(gq, wq, rtol=0, atol=1e-9)
        _close(gqd, wqd, rtol=0, atol=1e-9)
    else:
        _close(gq, wq, **Q_TOL)
        _close(gqd, wqd, **QD_TOL)


def test_mod_key_outside_the_four_takes_the_generic_route():
    """A mod key K3 does not take sends a spatial_ok body to the generic
    substep, which reads only the four keys of JAX's ``_phys`` (here
    body_mass) and ignores the rest, as the JAX Engine does."""
    jm, tm = _models("half_cheetah")
    q, qd, ctrl = _states(tm, 13)
    rng = np.random.default_rng(2)
    mass = rng.uniform(0.5, 1.5, (B, tm.nb))
    with jax.enable_x64():
        je = _jengine(jm, True)
        wq, wqd = jax.jit(jax.vmap(lambda a, b, c, m, g: je.step(
            a, b, c, 5, {"body_mass": m, "geom_friction": g})))(
            *(jnp.asarray(x) for x in (q, qd, ctrl, mass,
                                       np.ones((B, 3)))))
    engine = Engine(tm)
    before = Engine.generic_substeps
    gq, gqd = engine.step(torch.tensor(q), torch.tensor(qd),
                          torch.tensor(ctrl), 5,
                          {"body_mass": torch.tensor(mass),
                           "geom_friction": torch.ones((B, 3))})
    assert Engine.generic_substeps - before == 5
    assert "_chain_cache" not in engine.__dict__    # K2/K3 never built
    _close(gq, wq, rtol=0, atol=1e-9)
    _close(gqd, wqd, rtol=0, atol=1e-9)
    # the multiplier acts: the unmodded step differs
    uq, _ = engine.generic_step(torch.tensor(q), torch.tensor(qd),
                                torch.tensor(ctrl), 5)
    assert (uq - gq).abs().max() > 1e-6


def test_generic_substep_matches_k2_plain_on_the_cheetah():
    """The generic route and K2's plain version (the emitted spatial
    substep) are two formulations of one physics: one env step of the
    cheetah from rollout-like and random states, float32, at the K2 bars."""
    tm = get_model("half_cheetah")
    engine = Engine(tm)
    rng = np.random.default_rng(4)
    q = tm.init_qpos + 0.3 * rng.standard_normal((16, tm.nv))
    q[:, 1] -= 0.1                        # feet in the ground: contacts act
    qd = rng.standard_normal((16, tm.nv))
    ctrl = rng.uniform(-1, 1, (16, tm.nu))
    args = [torch.tensor(x, dtype=torch.float32) for x in (q, qd, ctrl)]
    k2q, k2qd = engine.step(*args, 5)
    assert set(engine._chain_cache) == {(5, ())}
    gq, gqd = engine.generic_step(*args, 5)
    _close(gq, k2q.numpy(), **Q_TOL)
    _close(gqd, k2qd.numpy(), **QD_TOL)
    # on the CPU no kernel is launched
    assert sk.substep_chain.launches == 0


def test_k3_keys_keep_their_kernel_route():
    """A spatial_ok body with K3's four keys still takes K3 (its plain
    version here), never the generic substep."""
    tm = get_model("hopper")
    engine = Engine(tm)
    q, qd, ctrl = (torch.tensor(x, dtype=torch.float32)
                   for x in _states(tm, 8))
    mods = {"body_mass": torch.ones((B, tm.nb)),
            "body_inertia": torch.ones((B, tm.nb, 3)),
            "dof_damping": torch.ones((B, tm.nv)),
            "friction": torch.ones((B,))}
    before = Engine.generic_substeps
    engine.step(q, qd, ctrl, 4, mods)
    engine.step(q, qd, ctrl, 4)
    assert Engine.generic_substeps == before
    assert set(engine._chain_cache) == {(4, ()), (4, tuple(sorted(mods)))}
