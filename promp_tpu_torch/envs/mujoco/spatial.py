"""Scalar-unrolled 3-D substep, emitted from the model spec (port of
promp_tpu/envs/mujoco/spatial.py, the ``contact_impl="scalar"``,
``list_io=True`` form that the TPU kernel K2 runs).

Every per-substep quantity is a scalar per env and every structural loop
is unrolled while the substep is built, through const-folding helpers:
model constants are Python floats, folded in float64 as the JAX helpers
fold them, so identity rotations, zero offsets and coordinate-axis joints
emit no operations. A value is either such a Python float or a back-end
value; the algebra is written once over a small back-end interface:

  * arithmetic ``+ - * /`` and negation as Python operators;
  * ``cos``, ``sin``, ``sqrt``, ``abs``, ``maximum``/``minimum``/``clip``
    against constants (NaN-propagating, as ``jnp.maximum``), and ``lt``/
    ``gt`` against a constant as 0/1 floats, as back-end methods;
  * ``lift(c)``, a constant as a back-end value.

Two back ends implement it: ``TorchOps`` (values are (B,) float32 tensors,
the substep runs eagerly: the plain version of K2 and K3) and ``CEmitter``
(values are named SSA temporaries ``const float tN = ...;``, the body of
K2's and K3's CUDA sources, ops/substep_kernel.py).

With rand-params mods (K3), the body masses, inertias, dof dampings and
the ground friction are multiplied by per-env multipliers: columns of a
packed (B, nm) input, (B,) tensors in the torch back end and named loads
``m[i]`` of the env's row in the C back end. Those products are back-end
values, so they no longer fold; without mods the body is K2's, unchanged.

Per substep (the same closed forms as the JAX package's substep):
  * FK with rotation matrices; the anchor rotation folds to
    ``p' = anchor + R_new @ (-jnt_pos)``;
  * the CRBA mass matrix over root-recentered coordinates;
  * the RNEA bias (qdd = 0) over world Pluecker velocities;
  * penalty ground contacts with cone-clamped friction, each contact's
    Jacobian columns over its body's ancestor dofs only;
  * joint limits, springs and damping, with the implicit-Euler RHS mates;
  * a sparse Cholesky of (M + hC + h^2 K) eliminated leaves-first, whose
    fill pattern is computed symbolically here and stays in the tree's
    same-root-path pattern;
  * the qvel clip at +-max_qvel.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from promp_tpu_torch.envs.mujoco.model import HINGE

__all__ = ["spatial_ok", "make_spatial_substep", "TorchOps", "CEmitter",
           "c_float", "MOD_BASE_NDIM", "mod_rows", "unpack_mods"]


def spatial_ok(model) -> bool:
    """Static eligibility: no fluid medium (swimmer), no sphere-sphere
    contact pairs (manipulation scenes), no ground-skip spheres."""
    if model.density != 0.0 or model.viscosity != 0.0:
        return False
    if len(model.pair_a) or len(model.pair_b):
        return False
    if len(model.con_skip_ground) and any(model.con_skip_ground):
        return False
    return True


# ---------------------------------------------------------------- back ends
class TorchOps:
    """Back end of the plain version: values are (B,) float32 tensors.
    ``torch.clamp`` propagates NaN as ``jnp.maximum``/``minimum`` do."""

    def __init__(self, like):
        self._like = like

    def lift(self, c):
        return torch.full_like(self._like, float(c))

    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)

    @staticmethod
    def maximum(x, c):
        return torch.clamp(x, min=c)

    @staticmethod
    def minimum(x, c):
        return torch.clamp(x, max=c)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def lt(x, c):
        return (x < c).to(x.dtype)

    @staticmethod
    def gt(x, c):
        return (x > c).to(x.dtype)


_TEMP = re.compile(r"\bt(\d+)\b")


def c_float(c):
    """``c`` rounded once to float32, as a C float literal that parses back
    to exactly ``np.float32(c)`` (the shortest such decimal)."""
    with np.errstate(over="ignore"):
        f = np.float32(c)
    if not np.isfinite(f):
        raise ValueError(f"constant {c!r} is not finite in float32")
    text = np.format_float_scientific(f, unique=True) + "f"
    return f"({text})" if text.startswith("-") else text


class _Sym:
    """A named float32 temporary of the C back end."""

    __slots__ = ("em", "name")
    __array_priority__ = 1000  # numpy scalars defer to the reflected ops

    def __init__(self, em, name):
        self.em, self.name = em, name

    def _bin(self, op, other, reflected=False):
        a, b = self.name, self.em.operand(other)
        return self.em.emit(f"{b} {op} {a}" if reflected else f"{a} {op} {b}")

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, True)

    def __neg__(self):
        return self.em.emit(f"-{self.name}")


class CEmitter:
    """Back end of K2's and K3's CUDA source: each operation records one
    line ``tN = <expr>`` (``n_ops`` float operations, reading the
    temporaries ``deps``) and returns the name ``tN``. Every constant is
    written by ``c_float``; ``literals`` keeps each (constant, literal)
    pair. ``nan_max``/``nan_min`` are the template's NaN-propagating
    max/min. ops/substep_schedule.py places the lines the outputs need."""

    def __init__(self):
        self._lines = []                  # (expr, n_ops, deps)
        self.literals = []

    def var(self, name):
        return _Sym(self, name)

    def operand(self, x):
        if isinstance(x, _Sym):
            return x.name
        lit = c_float(x)
        self.literals.append((float(x), lit))
        return lit

    def emit(self, expr, n_ops=1):
        deps = [int(i) for i in _TEMP.findall(expr)]
        self._lines.append((expr, n_ops, deps))
        return _Sym(self, f"t{len(self._lines) - 1}")

    @property
    def lines(self):
        """Every recorded ``(expr, n_ops, deps)``; temporary i is line i
        (the folding helpers leave some dead, as the JAX trace does)."""
        return self._lines

    def lift(self, c):
        return self.emit(self.operand(c), 0)

    def _call(self, fn, x):
        return self.emit(f"{fn}({x.name})")

    def cos(self, x):
        return self._call("cosf", x)

    def sin(self, x):
        return self._call("sinf", x)

    def sqrt(self, x):
        return self._call("sqrtf", x)

    def abs(self, x):
        return self._call("fabsf", x)

    def maximum(self, x, c):
        return self.emit(f"nan_max({x.name}, {self.operand(c)})")

    def minimum(self, x, c):
        return self.emit(f"nan_min({x.name}, {self.operand(c)})")

    def clip(self, x, lo, hi):
        return self.emit(f"nan_min(nan_max({x.name}, {self.operand(lo)}), "
                         f"{self.operand(hi)})", 2)

    def lt(self, x, c):
        return self.emit(f"({x.name} < {self.operand(c)}) ? 1.0f : 0.0f")

    def gt(self, x, c):
        return self.emit(f"({x.name} > {self.operand(c)}) ? 1.0f : 0.0f")


# ---------------------------------------------------------------- scalars
# Constants are Python floats, folded in float64; a constant meeting a
# back-end value is rounded to float32 by the operation, as a Python float
# meeting a float32 array is in JAX.

def _c(x) -> bool:
    return isinstance(x, (int, float))


def _mul(a, b):
    if _c(a) and _c(b):
        return float(a) * float(b)
    if _c(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return -b
        return float(a) * b
    if _c(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return -a
        return a * float(b)
    return a * b


def _add(a, b):
    if _c(a):
        if a == 0.0:
            return b
        if _c(b):
            return float(a) + float(b)
    if _c(b) and b == 0.0:
        return a
    if _c(a):
        return float(a) + b
    if _c(b):
        return a + float(b)
    return a + b


def _sub(a, b):
    if _c(b):
        if b == 0.0:
            return a
        if _c(a):
            return float(a) - float(b)
        return a - float(b)
    if _c(a):
        if a == 0.0:
            return -b
        return float(a) - b
    return a - b


def _dot3(u, v):
    return _add(_add(_mul(u[0], v[0]), _mul(u[1], v[1])), _mul(u[2], v[2]))


def _cross(u, v):
    return (_sub(_mul(u[1], v[2]), _mul(u[2], v[1])),
            _sub(_mul(u[2], v[0]), _mul(u[0], v[2])),
            _sub(_mul(u[0], v[1]), _mul(u[1], v[0])))


def _vadd(u, v):
    return tuple(_add(a, b) for a, b in zip(u, v))


def _vsub(u, v):
    return tuple(_sub(a, b) for a, b in zip(u, v))


def _vscale(u, s):
    return tuple(_mul(a, s) for a in u)


def _matvec(R, v):
    """R: tuple of 9 (row-major), v: vec3."""
    return (_add(_add(_mul(R[0], v[0]), _mul(R[1], v[1])), _mul(R[2], v[2])),
            _add(_add(_mul(R[3], v[0]), _mul(R[4], v[1])), _mul(R[5], v[2])),
            _add(_add(_mul(R[6], v[0]), _mul(R[7], v[1])), _mul(R[8], v[2])))


def _matmul(A, B):
    out = []
    for i in range(3):
        for j in range(3):
            out.append(_add(_add(_mul(A[3 * i + 0], B[0 + j]),
                                 _mul(A[3 * i + 1], B[3 + j])),
                            _mul(A[3 * i + 2], B[6 + j])))
    return tuple(out)


_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _quat_mat_const(q):
    """Constant quaternion -> row-major 9-tuple of floats."""
    w, x, y, z = [float(v) for v in q]
    if abs(w - 1.0) < 1e-12 and abs(x) + abs(y) + abs(z) < 1e-12:
        return _IDENTITY
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def _rodrigues_const_axis(ops, axis, angle):
    """Rotation about a CONSTANT unit axis by a traced angle; entries are
    affine in (cos, sin) with constant coefficients."""
    x, y, z = [float(v) for v in axis]
    cth = ops.cos(angle)
    sth = ops.sin(angle)
    C = _sub(1.0, cth)
    return (_add(cth, _mul(x * x, C)),
            _sub(_mul(x * y, C), _mul(z, sth)),
            _add(_mul(x * z, C), _mul(y, sth)),
            _add(_mul(x * y, C), _mul(z, sth)),
            _add(cth, _mul(y * y, C)),
            _sub(_mul(y * z, C), _mul(x, sth)),
            _sub(_mul(x * z, C), _mul(y, sth)),
            _add(_mul(y * z, C), _mul(x, sth)),
            _add(cth, _mul(z * z, C)))


# sym3 = (xx, yy, zz, xy, xz, yz)

def _sym_matvec(S, v):
    return (_add(_add(_mul(S[0], v[0]), _mul(S[3], v[1])), _mul(S[4], v[2])),
            _add(_add(_mul(S[3], v[0]), _mul(S[1], v[1])), _mul(S[5], v[2])),
            _add(_add(_mul(S[4], v[0]), _mul(S[5], v[1])), _mul(S[2], v[2])))


def _sym_add(A, B):
    return tuple(_add(a, b) for a, b in zip(A, B))


# ---------------------------------------------------------------- mods
# Rand-params multiplier keys the substep takes (JAX pallas_substep.py
# _MOD_BASE_NDIM): the number of trailing axes of one instance's multiplier.
MOD_BASE_NDIM = {"body_mass": 1, "body_inertia": 2, "dof_damping": 1,
                 "friction": 0}


def mod_rows(model, key):
    """Packed row count of one mod key."""
    return {"body_mass": model.nb, "body_inertia": 3 * model.nb,
            "dof_damping": model.nv, "friction": 1}[key]


def unpack_mods(model, mod_keys, row):
    """The ``mods`` dict of the substep from a packed mods row: ``row(i)``
    is the back-end value of packed column i, the keys' columns laid out
    in ``mod_keys`` order (body_inertia's [b, k] at 3 b + k), as JAX's
    ``_pack_mods`` lays them out."""
    d, off = {}, 0
    for k in mod_keys:
        if k == "body_mass":
            d[k] = [row(off + b) for b in range(model.nb)]
        elif k == "body_inertia":
            d[k] = [[row(off + 3 * b + c) for c in range(3)]
                    for b in range(model.nb)]
        elif k == "dof_damping":
            d[k] = [row(off + j) for j in range(model.nv)]
        elif k == "friction":
            d[k] = row(off)
        off += mod_rows(model, k)
    return d


def _value(ops, x):
    """A back-end value: ``x`` itself, or the constant ``x`` lifted."""
    return ops.lift(x) if _c(x) else x


def make_spatial_substep(engine):
    """Build the substep of ``engine``'s model.

    Returns ``substep(ops, qs, qds, taus, probe=None, mods=None) ->
    (q_new, qd_new)`` over per-dof lists of back-end values, with the
    substep length ``h = timestep / n_substeps`` folded in as a Python
    float, as the TPU kernel folds it. ``probe``, a list, receives each
    contact's 0/1 in-contact value. ``mods``, from ``unpack_mods``, holds
    rand-params multipliers as back-end values; each given key turns its
    constants (body masses, inertias, dof dampings, the ground friction)
    into back-end products.
    """
    m = engine.model
    if not spatial_ok(m):
        raise ValueError(f"model is not spatial_ok (fluid, contact pairs or "
                         f"ground-skip spheres): {m.nv} dofs, density "
                         f"{m.density}, {len(m.pair_a)} pairs")
    nv, nb, nc = m.nv, m.nb, len(m.con_body)
    h = float(m.timestep / engine.n_substeps)

    # ---- static structure
    dofs_of_body = [[] for _ in range(nb)]
    for j, b in enumerate(m.jnt_body):
        dofs_of_body[b].append(j)
    body_chain = []                       # ancestor bodies incl self
    for b in range(nb):
        chain = []
        cur = b
        while cur >= 0:
            chain.append(cur)
            cur = m.body_parent[cur]
        body_chain.append(list(reversed(chain)))
    # dofs moving body b, tree order
    anc_dofs = [sorted(sum((dofs_of_body[cb] for cb in body_chain[b]), []))
                for b in range(nb)]

    is_hinge = [t == HINGE for t in m.jnt_type]
    jnt_axis = np.asarray(m.jnt_axis, np.float64)
    jnt_pos = np.asarray(m.jnt_pos, np.float64)
    jnt_ref = [float(r) for r in np.asarray(m.jnt_ref, np.float64)]
    body_pos = np.asarray(m.body_pos, np.float64)
    body_quat_mat = [_quat_mat_const(m.body_quat[b]) for b in range(nb)]
    iquat_mat = [_quat_mat_const(m.body_iquat[b]) for b in range(nb)]
    ipos = np.asarray(m.body_ipos, np.float64)
    con_pos = np.asarray(m.con_pos, np.float64)
    con_radius = [float(r) for r in np.asarray(m.con_radius, np.float64)]
    con_body = list(m.con_body)

    limited = [(abs(m.jnt_range[j, 0]) + abs(m.jnt_range[j, 1])) > 0
               for j in range(nv)]
    jr_lo = [float(v) for v in np.asarray(m.jnt_range[:, 0], np.float64)]
    jr_hi = [float(v) for v in np.asarray(m.jnt_range[:, 1], np.float64)]
    stiffness = [float(v) for v in np.asarray(m.jnt_stiffness, np.float64)]
    springref = [float(v) for v in np.asarray(m.jnt_springref, np.float64)]
    armature = [float(v) for v in np.asarray(m.dof_armature, np.float64)]
    gravity = float(m.gravity)

    k_con = float(engine.contact_stiffness)
    c_con = float(engine.contact_damping)
    ct_max = float(engine.contact_tangential_damping)
    k_lim = float(engine.limit_stiffness)
    c_lim = float(engine.limit_damping)
    max_qvel = float(engine.max_qvel)
    solve_reg = float(engine.solve_reg)

    # ---- sparsity pattern + elimination order of the unrolled solve: (i,
    # j) is structurally nonzero iff i and j lie on a common root path.
    # Eliminating leaves-first (reverse dof order) is a perfect elimination
    # order for a tree; the symbolic pass checks that fill stays inside the
    # pattern.
    pattern = np.zeros((nv, nv), bool)
    for b in range(nb):
        for j in dofs_of_body[b]:
            for i in anc_dofs[b]:
                pattern[max(i, j), min(i, j)] = True
    for j in range(nv):
        pattern[j, j] = True
    perm = list(range(nv - 1, -1, -1))    # elimination pos -> original dof
    nzp = np.zeros((nv, nv), bool)        # permuted lower pattern
    for p1 in range(nv):
        for p2 in range(p1 + 1):
            o1, o2 = perm[p1], perm[p2]
            nzp[p1, p2] = pattern[max(o1, o2), min(o1, o2)]
    pattern_p = nzp.copy()
    for j in range(nv):                   # symbolic fill
        rows = [i for i in range(j + 1, nv) if nzp[i, j]]
        for a in rows:
            for bb in rows:
                if a >= bb:
                    nzp[a, bb] = True
    if (nzp & ~pattern_p).any():
        raise AssertionError("Cholesky fill left the tree's sparsity pattern")

    def substep(ops, q, qd, tau_act, probe=None, mods=None):
        def mod1(name, idx, base):
            if mods and name in mods:
                return base * mods[name][idx]
            return base

        qs = [q[j] for j in range(nv)]
        qds = [qd[j] for j in range(nv)]

        # the rand-params multipliers scale these constants with a plain
        # product (no folding), as the JAX substep does; without mods they
        # stay Python floats and fold
        mass = [mod1("body_mass", b, float(m.body_mass[b]))
                for b in range(nb)]
        if mods and "body_inertia" in mods:
            inertia = [[float(m.body_inertia[b, k])
                        * mods["body_inertia"][b][k] for k in range(3)]
                       for b in range(nb)]
        else:
            inertia = [[float(m.body_inertia[b, k]) for k in range(3)]
                       for b in range(nb)]
        damping = [mod1("dof_damping", j, float(m.dof_damping[j]))
                   for j in range(nv)]
        friction = (mods["friction"] * float(m.friction)
                    if mods and "friction" in mods else float(m.friction))

        # ------------------------------------------------------------- fk
        R = [None] * nb                    # row-major 9-tuples
        p = [None] * nb                    # world origins, vec3
        axis_w = [None] * nv
        anchor_w = [None] * nv
        for b in range(nb):
            pa = m.body_parent[b]
            if pa < 0:
                Rb = _IDENTITY
                pb = (float(body_pos[b, 0]), float(body_pos[b, 1]),
                      float(body_pos[b, 2]))
            else:
                Rb = R[pa]
                pb = _vadd(p[pa], _matvec(R[pa], tuple(body_pos[b])))
            if body_quat_mat[b] is not _IDENTITY:
                Rb = _matmul(Rb, body_quat_mat[b])
            for j in dofs_of_body[b]:
                ax_local = tuple(jnt_axis[j])
                aw = _matvec(Rb, ax_local)
                anw = _vadd(pb, _matvec(Rb, tuple(jnt_pos[j])))
                axis_w[j] = aw
                anchor_w[j] = anw
                dqj = _sub(qs[j], jnt_ref[j])
                if not is_hinge[j]:
                    pb = _vadd(pb, _vscale(aw, dqj))
                else:
                    Rb = _matmul(Rb, _rodrigues_const_axis(
                        ops, ax_local, _value(ops, dqj)))
                    # p' = anchor + R_new @ (-jnt_pos)
                    if np.abs(jnt_pos[j]).max() > 0:
                        pb = _vadd(anw, _matvec(Rb, tuple(-jnt_pos[j])))
            R[b], p[b] = Rb, pb

        # root-recentered coordinates: small float32 lever arms
        origin = p[0]
        com = [None] * nb
        R_wi = [None] * nb                 # world <- inertial frame
        for b in range(nb):
            com[b] = _vsub(_vadd(p[b], _matvec(R[b], tuple(ipos[b]))),
                           origin)
            R_wi[b] = (R[b] if iquat_mat[b] is _IDENTITY
                       else _matmul(R[b], iquat_mat[b]))
        anchor_rel = [_vsub(anchor_w[j], origin) for j in range(nv)]

        # world inertia about the COM, sym3: sum_k I_k col_k col_k^T
        I_w = [None] * nb
        for b in range(nb):
            Rb = R_wi[b]
            cols = [(Rb[0], Rb[3], Rb[6]), (Rb[1], Rb[4], Rb[7]),
                    (Rb[2], Rb[5], Rb[8])]
            ent = [0.0] * 6
            for k in range(3):
                ck = cols[k]
                Ik = inertia[b][k]
                ent[0] = _add(ent[0], _mul(Ik, _mul(ck[0], ck[0])))
                ent[1] = _add(ent[1], _mul(Ik, _mul(ck[1], ck[1])))
                ent[2] = _add(ent[2], _mul(Ik, _mul(ck[2], ck[2])))
                ent[3] = _add(ent[3], _mul(Ik, _mul(ck[0], ck[1])))
                ent[4] = _add(ent[4], _mul(Ik, _mul(ck[0], ck[2])))
                ent[5] = _add(ent[5], _mul(Ik, _mul(ck[1], ck[2])))
            I_w[b] = tuple(ent)

        # motion subspaces S_j = (w, v_O) at the recentered origin
        Sw = [None] * nv
        Sv = [None] * nv
        for j in range(nv):
            if is_hinge[j]:
                Sw[j] = axis_w[j]
                Sv[j] = _cross(anchor_rel[j], axis_w[j])
            else:
                Sw[j] = (0.0, 0.0, 0.0)
                Sv[j] = axis_w[j]

        # ----------------------------------------------- mass matrix (CRBA)
        # composite inertia about O in additive (m, h, I_O) form
        cm = [None] * nb
        ch = [None] * nb
        cI = [None] * nb
        for b in range(nb):
            c = com[b]
            mb = mass[b]
            hb = _vscale(c, mb)
            cc = _dot3(c, c)
            # I_O = I_com + m (c.c E - c c^T)
            IO = (_add(I_w[b][0], _mul(mb, _sub(cc, _mul(c[0], c[0])))),
                  _add(I_w[b][1], _mul(mb, _sub(cc, _mul(c[1], c[1])))),
                  _add(I_w[b][2], _mul(mb, _sub(cc, _mul(c[2], c[2])))),
                  _sub(I_w[b][3], _mul(mb, _mul(c[0], c[1]))),
                  _sub(I_w[b][4], _mul(mb, _mul(c[0], c[2]))),
                  _sub(I_w[b][5], _mul(mb, _mul(c[1], c[2]))))
            cm[b], ch[b], cI[b] = mb, hb, IO
        for b in range(nb - 1, -1, -1):    # leaf-to-root accumulation
            pa = m.body_parent[b]
            if pa >= 0:
                cm[pa] = _add(cm[pa], cm[b])
                ch[pa] = _vadd(ch[pa], ch[b])
                cI[pa] = _sym_add(cI[pa], cI[b])

        Ment = {}
        for j in range(nv):
            bj = m.jnt_body[j]
            w, v = Sw[j], Sv[j]
            # F_j = I^C_{b(j)} S_j: f = m v + w x h ; n = I_O w + h x v
            f = _vadd(_vscale(v, cm[bj]), _cross(w, ch[bj]))
            n = _vadd(_sym_matvec(cI[bj], w), _cross(ch[bj], v))
            for i in anc_dofs[bj]:
                key = (max(i, j), min(i, j))
                if key not in Ment:
                    Ment[key] = _add(_dot3(Sw[i], n), _dot3(Sv[i], f))
        for j in range(nv):
            if armature[j] != 0.0:
                Ment[(j, j)] = _add(Ment[(j, j)], armature[j])

        # --------------------------------------- bias (RNEA, qdd = 0)
        def cross_motion(w1, v1, w2, v2):
            return _cross(w1, w2), _vadd(_cross(w1, v2), _cross(v1, w2))

        Vw = [None] * nb
        Vv = [None] * nb
        Aw = [None] * nb
        Av = [None] * nb
        for b in range(nb):
            pa = m.body_parent[b]
            if pa < 0:
                vw, vv = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
                aw = (0.0, 0.0, 0.0)
                av = (0.0, 0.0, -gravity)   # base accel = -a_g
            else:
                vw, vv = Vw[pa], Vv[pa]
                aw, av = Aw[pa], Av[pa]
            for j in dofs_of_body[b]:
                dw, dv = cross_motion(vw, vv, Sw[j], Sv[j])
                aw = _vadd(aw, _vscale(dw, qds[j]))
                av = _vadd(av, _vscale(dv, qds[j]))
                vw = _vadd(vw, _vscale(Sw[j], qds[j]))
                vv = _vadd(vv, _vscale(Sv[j], qds[j]))
            Vw[b], Vv[b] = vw, vv
            Aw[b], Av[b] = aw, av

        Fw = [None] * nb
        Fv = [None] * nb
        for b in range(nb):
            c = com[b]
            mb = mass[b]

            def inertia_apply(w, v):
                vc = _vadd(v, _cross(w, c))
                f = _vscale(vc, mb)
                n = _vadd(_sym_matvec(I_w[b], w), _cross(c, f))
                return n, f

            n_a, f_a = inertia_apply(Aw[b], Av[b])
            n_v, f_v = inertia_apply(Vw[b], Vv[b])
            # V x* F = (w x n + v x f, w x f)
            Fw[b] = _vadd(n_a, _vadd(_cross(Vw[b], n_v),
                                     _cross(Vv[b], f_v)))
            Fv[b] = _vadd(f_a, _cross(Vw[b], f_v))
        for b in range(nb - 1, -1, -1):    # subtree force sums
            pa = m.body_parent[b]
            if pa >= 0:
                Fw[pa] = _vadd(Fw[pa], Fw[b])
                Fv[pa] = _vadd(Fv[pa], Fv[b])
        bias = [_add(_dot3(Sw[j], Fw[m.jnt_body[j]]),
                     _dot3(Sv[j], Fv[m.jnt_body[j]]))
                for j in range(nv)]

        # ------------------------------------------------------ contacts
        # per-contact scalar loops
        tau_con = [0.0] * nv
        Aent = {}
        for ci in range(nc):
            b = con_body[ci]
            P_abs = _vadd(p[b], _matvec(R[b], tuple(con_pos[ci])))
            Pr = _vsub(P_abs, origin)
            # point velocity from the body spatial velocity
            vel = _vadd(Vv[b], _cross(Vw[b], Pr))
            phi = _value(ops, _sub(P_abs[2], con_radius[ci]))
            in_con = ops.lt(phi, 0.0)
            if probe is not None:
                probe.append(in_con)
            fn = _mul(ops.maximum(_value(ops, _sub(_mul(k_con, -phi),
                                                   _mul(c_con, vel[2]))),
                                  0.0),
                      in_con)
            vt_norm = ops.sqrt(_value(ops, _add(
                _add(_mul(vel[0], vel[0]), _mul(vel[1], vel[1])), 1e-8)))
            ct_eff = _mul(ops.minimum(friction * fn / vt_norm, ct_max),
                          in_con)
            active = _mul(in_con, ops.gt(fn, 0.0))
            cn_eff = _mul(c_con, active)
            kn_eff = _mul(k_con, active)
            wt = _mul(h, ct_eff)
            wn = _add(_mul(h, cn_eff), _mul(_mul(h, h), kn_eff))
            # force for tau, with the RHS mate of the implicit h^2 K term
            # folded into the normal component
            fz = _sub(fn, _mul(h, _mul(kn_eff, vel[2])))
            fx = _mul(-ct_eff, vel[0])
            fy = _mul(-ct_eff, vel[1])
            dofs = anc_dofs[b]
            cols = []
            for j in dofs:
                if is_hinge[j]:
                    cols.append(_cross(axis_w[j],
                                       _vsub(Pr, anchor_rel[j])))
                else:
                    cols.append(axis_w[j])
            for dj, col in zip(dofs, cols):
                tau_con[dj] = _add(tau_con[dj],
                                   _add(_add(_mul(col[0], fx),
                                             _mul(col[1], fy)),
                                        _mul(col[2], fz)))
            # A += h ct (Jx Jx^T + Jy Jy^T) + (h cn + h^2 kn) Jz Jz^T
            wtx = [_mul(wt, col[0]) for col in cols]
            wty = [_mul(wt, col[1]) for col in cols]
            wnz = [_mul(wn, col[2]) for col in cols]
            for a in range(len(dofs)):
                ja = dofs[a]
                for bi in range(a + 1):
                    jb = dofs[bi]
                    cb = cols[bi]
                    key = (max(ja, jb), min(ja, jb))
                    term = _add(_add(_mul(wtx[a], cb[0]),
                                     _mul(wty[a], cb[1])),
                                _mul(wnz[a], cb[2]))
                    Aent[key] = _add(Aent.get(key, 0.0), term)

        # --------------------------------- limits / springs / damping
        tau = [None] * nv
        diag_cd = [None] * nv
        for j in range(nv):
            tj = _add(_sub(tau_act[j], bias[j]), tau_con[j])
            c_l = 0.0
            k_l = 0.0
            if limited[j]:
                below = ops.minimum(_value(ops, _sub(qs[j], jr_lo[j])), 0.0)
                above = ops.maximum(_value(ops, _sub(qs[j], jr_hi[j])), 0.0)
                viol = _add(below, above)
                active = ops.gt(ops.abs(_value(ops, viol)), 0.0)
                tj = _sub(tj, _add(_mul(k_lim, viol),
                                   _mul(_mul(c_lim, qds[j]), active)))
                c_l = _mul(c_lim, active)
                k_l = _mul(k_lim, active)
            if stiffness[j] != 0.0:
                tj = _sub(tj, _mul(stiffness[j],
                                   _sub(qs[j], springref[j])))
            tj = _sub(tj, _mul(damping[j], qds[j]))
            # consistent implicit-Euler RHS for position-stiffness terms
            tj = _sub(tj, _mul(_mul(h, _add(k_l, stiffness[j])), qds[j]))
            diag_cd[j] = _add(_mul(h, _add(damping[j], c_l)),
                              _mul(_mul(h, h), _add(k_l, stiffness[j])))
            tau[j] = _value(ops, tj)

        # ------------------------------------------- regularized solve
        tr = Ment[(0, 0)]
        for j in range(1, nv):
            tr = _add(tr, Ment[(j, j)])
        reg = _mul(solve_reg / nv, tr)

        def a_entry(i, j):                 # original dof indices, i >= j
            e = Ment.get((i, j), 0.0)
            e = _add(e, Aent.get((i, j), 0.0))
            if i == j:
                e = _add(e, _add(diag_cd[i], reg))
            return e

        # sparse unrolled Cholesky in the permuted (leaves-first) order
        L = [[0.0] * (i + 1) for i in range(nv)]
        for j in range(nv):
            oj = perm[j]
            s = a_entry(oj, oj)
            for k in range(j):
                if nzp[j, k]:
                    s = _sub(s, _mul(L[j][k], L[j][k]))
            d = ops.sqrt(ops.maximum(_value(ops, s), 1e-12))
            L[j][j] = d
            inv_d = 1.0 / d
            for i in range(j + 1, nv):
                if not nzp[i, j]:
                    continue
                oi = perm[i]
                s = a_entry(max(oi, oj), min(oi, oj))
                for k in range(j):
                    if nzp[i, k] and nzp[j, k]:
                        s = _sub(s, _mul(L[i][k], L[j][k]))
                L[i][j] = _mul(s, inv_d)

        y = [None] * nv
        for i in range(nv):
            s = tau[perm[i]]
            for k in range(i):
                if nzp[i, k]:
                    s = _sub(s, _mul(L[i][k], y[k]))
            y[i] = s / L[i][i]
        xp = [None] * nv
        for i in range(nv - 1, -1, -1):
            s = y[i]
            for k in range(i + 1, nv):
                if nzp[k, i]:
                    s = _sub(s, _mul(L[k][i], xp[k]))
            xp[i] = s / L[i][i]
        qdd = [None] * nv
        for pos, oj in enumerate(perm):
            qdd[oj] = xp[pos]

        qd_new = [ops.clip(_value(ops, _add(qds[j], _mul(h, qdd[j]))),
                           -max_qvel, max_qvel)
                  for j in range(nv)]
        q_new = [_value(ops, _add(qs[j], _mul(h, qd_new[j])))
                 for j in range(nv)]
        return q_new, qd_new

    return substep
