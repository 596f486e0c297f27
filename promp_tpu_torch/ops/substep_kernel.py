"""K2 and K3: the fused substep chain (port of
promp_tpu/ops/pallas_substep.py, ``make_pallas_chain`` without and with
rand-params ``mod_keys``).

``substep_chain(engine, n_steps)`` returns ``chain(q, qd, tau) -> (q2,
qd2)`` over (B, nv) float32 tensors: ``n_steps`` implicit-Euler substeps of
``engine``'s model with the torque held fixed (K2). With ``mod_keys``, the
chain takes a fourth input, the per-env rand-params multipliers packed
(B, nm) by ``pack_mods``, and scales the model's masses, inertias, dof
dampings and ground friction by them (K3). On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs ``substep_chain_plain``, the same
emitted algebra run eagerly in PyTorch (envs/mujoco/spatial.py).

K2's CUDA source is ``csrc/substep_chain.cu`` and K3's
``csrc/substep_chain_mods.cu``, each with the substep generated from the
model spec by the spatial emitter's C back end: every model constant folded
in, and in K3 the multiplied ones read from the env's mods row. At the
first CUDA call for a model the filled-in source is compiled with nvcc
into a shared library with a plain C entry point (ops/nvcc_build.py) and
loaded with ``ctypes``; never at import.
"""
from __future__ import annotations

import ctypes

import torch

from promp_tpu_torch.envs.mujoco.spatial import (
    MOD_BASE_NDIM, CEmitter, TorchOps, make_spatial_substep, mod_rows,
    unpack_mods)
from promp_tpu_torch.ops import nvcc_build

TEMPLATE, TEMPLATE_MODS = "substep_chain.cu", "substep_chain_mods.cu"
NV_MARK, NM_MARK, BODY_MARK = "/*@NV@*/", "/*@NM@*/", "/*@BODY@*/"
# -fmad=false: no multiply-add contraction, so K2 and K3 round op for op
# like their plain version (csrc/substep_chain.cu); -Xptxas -v reports
# registers and spills in the build log
NVCC_FLAGS = nvcc_build.BASE_FLAGS + ("-fmad=false", "-Xptxas=-v")


def check_mod_keys(mod_keys):
    """``mod_keys`` as a tuple; raises NotImplementedError naming any key
    that K3 does not take. (The JAX package runs such mods on its generic
    engine, which the port does not have; the port never falls back.)"""
    mod_keys = tuple(mod_keys)
    for k in mod_keys:
        if k not in MOD_BASE_NDIM:
            raise NotImplementedError(
                f"rand-params mod key {k!r} is not supported by K3 "
                f"(supported: {sorted(MOD_BASE_NDIM)})")
    return mod_keys


def n_mods(model, mod_keys):
    """nm, the packed mods row's length."""
    return sum(mod_rows(model, k) for k in check_mod_keys(mod_keys))


def pack_mods(model, mod_keys, mods, batch_shape):
    """A dict of multipliers with ``batch_shape`` (or a shape that
    broadcasts to it, e.g. (tasks, 1)) in front -> one contiguous (B, nm)
    float32 tensor, the keys' columns in ``mod_keys`` order (JAX
    ``_pack_mods``). A new tensor each call."""
    batch_shape = tuple(batch_shape)
    cols = []
    for k in check_mod_keys(mod_keys):
        v, nd, rows = mods[k], MOD_BASE_NDIM[k], mod_rows(model, k)
        base = tuple(v.shape[v.dim() - nd:])
        if len(base) != nd or torch.Size(base).numel() != rows:
            raise ValueError(f"mods[{k!r}] has shape {tuple(v.shape)}, "
                             f"expected {rows} values an env")
        v = torch.broadcast_to(v.to(torch.float32), batch_shape + base)
        cols.append(v.reshape(-1, rows))
    return torch.cat(cols, dim=1)


class SubstepSource:
    """K2's CUDA source for one engine, or K3's with ``mod_keys``:
    ``text``, the emitted body's ``n_ops`` float operations a substep, the
    (constant, literal) pairs it wrote and ``nm``."""

    def __init__(self, engine, mod_keys=()):
        m = engine.model
        mod_keys = check_mod_keys(mod_keys)
        self.nm = n_mods(m, mod_keys)
        em = CEmitter()
        q = [em.var(f"q[{j}]") for j in range(m.nv)]
        qd = [em.var(f"qd[{j}]") for j in range(m.nv)]
        tau = [em.var(f"tau[{j}]") for j in range(m.nv)]
        mods = (unpack_mods(m, mod_keys, lambda i: em.var(f"m[{i}]"))
                if mod_keys else None)
        q2, qd2 = make_spatial_substep(engine)(em, q, qd, tau, mods=mods)
        body, self.n_ops = em.body([x.name for x in q2 + qd2])
        body += [f"q[{j}] = {q2[j].name};" for j in range(m.nv)]
        body += [f"qd[{j}] = {qd2[j].name};" for j in range(m.nv)]
        name = TEMPLATE_MODS if mod_keys else TEMPLATE
        marks = {NV_MARK: str(m.nv), BODY_MARK: "\n".join(
            "    " + line for line in body)}
        if mod_keys:
            marks[NM_MARK] = str(self.nm)
        text = nvcc_build.read_source(name)
        for mark, value in marks.items():
            if text.count(mark) != 1:
                raise ValueError(f"{name} must mark {mark} once")
            text = text.replace(mark, value)
        self.text = text
        self.literals = list(em.literals)


def _check(nv, nm, **tensors):
    q = tensors["q"]
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"substep_chain: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    for name, t in tensors.items():
        cols = nm if name == "mods_packed" else nv
        if t.dim() != 2 or t.shape[0] != q.shape[0] or t.shape[1] != cols:
            raise ValueError(f"substep_chain: {name} has shape "
                             f"{tuple(t.shape)}, expected (B, {cols}) with "
                             f"q's B")
        if t.dtype != torch.float32:
            raise ValueError(f"substep_chain: {name} is {t.dtype}, expected "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"substep_chain: {name} is not contiguous")


def substep_chain_plain(engine, n_steps, mod_keys=()):
    """The plain version of K2: ``chain(q, qd, tau, probe=None) -> (q2,
    qd2)``, the emitted substep run eagerly on (B,) tensors per dof; with
    ``mod_keys``, of K3: ``chain(q, qd, tau, mods_packed, probe=None)``.
    ``probe``, a list, receives each substep's per-contact 0/1 in-contact
    tensors."""
    model = engine.model
    mod_keys = check_mod_keys(mod_keys)
    substep = make_spatial_substep(engine)

    def run(q, qd, tau, mods_packed, probe):
        ops = TorchOps(q[:, 0])
        mods = (unpack_mods(model, mod_keys, lambda i: mods_packed[:, i])
                if mod_keys else None)
        qs, qds, taus = list(q.unbind(1)), list(qd.unbind(1)), list(
            tau.unbind(1))
        for _ in range(n_steps):
            qs, qds = substep(ops, qs, qds, taus, probe, mods)
        return torch.stack(qs, 1), torch.stack(qds, 1)

    if mod_keys:
        def chain(q, qd, tau, mods_packed, probe=None):
            return run(q, qd, tau, mods_packed, probe)
    else:
        def chain(q, qd, tau, probe=None):
            return run(q, qd, tau, None, probe)
    return chain


def substep_chain(engine, n_steps, mod_keys=()):
    """K2's wrapper for ``engine`` and ``n_steps``: ``chain(q, qd, tau) ->
    (q2, qd2)`` over contiguous (B, nv) float32 tensors on one device; with
    ``mod_keys``, K3's: ``chain(q, qd, tau, mods_packed)`` with the (B, nm)
    multipliers of ``pack_mods``. On the CPU it runs the plain version; on
    CUDA it launches the kernel (building it at the first call) and counts
    the launch, K2's in ``substep_chain.launches`` and K3's in
    ``substep_chain.mods_launches``, or raises."""
    model = engine.model
    mod_keys = check_mod_keys(mod_keys)
    nv, nm = model.nv, n_mods(model, mod_keys)
    plain = substep_chain_plain(engine, n_steps, mod_keys)
    kernel = []

    def run(*ins):
        q = ins[0]
        if q.device.type == "cpu":
            return plain(*ins)
        if q.device.type != "cuda":
            raise ValueError(f"substep_chain: unsupported device {q.device}")
        if not kernel:
            kernel.append(_load(engine, mod_keys))
        q_out, qd_out = torch.empty_like(q), torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = kernel[0](*[t.data_ptr() for t in ins], q_out.data_ptr(),
                            qd_out.data_ptr(), q.shape[0], n_steps, stream)
        if err != 0:
            raise RuntimeError(f"substep_chain: {'K3' if mod_keys else 'K2'} "
                               f"launch failed with cudaError {err}")
        if mod_keys:
            substep_chain.mods_launches += 1
        else:
            substep_chain.launches += 1
        return q_out, qd_out

    if mod_keys:
        def chain(q, qd, tau, mods_packed):
            _check(nv, nm, q=q, qd=qd, tau=tau, mods_packed=mods_packed)
            return run(q, qd, tau, mods_packed)
    else:
        def chain(q, qd, tau):
            _check(nv, nm, q=q, qd=qd, tau=tau)
            return run(q, qd, tau)
    return chain


substep_chain.launches = 0        # K2
substep_chain.mods_launches = 0   # K3


def build_job(engine, mod_keys=()):
    """(name, source, flags) of K2's library for ``engine``, or K3's with
    ``mod_keys``, for ``nvcc_build.build_all``."""
    name = "substep_chain_mods" if mod_keys else "substep_chain"
    return (name, SubstepSource(engine, mod_keys).text, NVCC_FLAGS)


def _load(engine, mod_keys):
    lib = nvcc_build.load(nvcc_build.build(*build_job(engine, mod_keys)))
    if mod_keys:
        fn, n_ptrs = lib.substep_chain_mods_launch, 6
    else:
        fn, n_ptrs = lib.substep_chain_launch, 5
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
