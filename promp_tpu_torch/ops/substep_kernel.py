"""K2: the fused substep chain (port of promp_tpu/ops/pallas_substep.py,
``make_pallas_chain`` without rand-params mods).

``substep_chain(engine, n_steps)`` returns ``chain(q, qd, tau) -> (q2,
qd2)`` over (B, nv) float32 tensors: ``n_steps`` implicit-Euler substeps of
``engine``'s model with the torque held fixed. On CUDA tensors it launches
K2 or raises; on CPU tensors it runs ``substep_chain_plain``, the same
emitted algebra run eagerly in PyTorch (envs/mujoco/spatial.py).

K2's CUDA source is ``csrc/substep_chain.cu`` with the substep generated
from the model spec by the spatial emitter's C back end, every model
constant folded in. At the first CUDA call for a model the filled-in source
is compiled with nvcc into a shared library with a plain C entry point
(ops/nvcc_build.py) and loaded with ``ctypes``; never at import.
"""
from __future__ import annotations

import ctypes

import torch

from promp_tpu_torch.envs.mujoco.spatial import (CEmitter, TorchOps,
                                                 make_spatial_substep)
from promp_tpu_torch.ops import nvcc_build

TEMPLATE = "substep_chain.cu"
NV_MARK, BODY_MARK = "/*@NV@*/", "/*@BODY@*/"
# -fmad=false: no multiply-add contraction, so K2 rounds op for op like its
# plain version (csrc/substep_chain.cu); -Xptxas -v reports registers and
# spills in the build log
NVCC_FLAGS = nvcc_build.BASE_FLAGS + ("-fmad=false", "-Xptxas=-v")


class SubstepSource:
    """K2's CUDA source for one engine: ``text``, the emitted body's
    ``n_ops`` float operations a substep and the (constant, literal) pairs
    it wrote."""

    def __init__(self, engine):
        m = engine.model
        em = CEmitter()
        q = [em.var(f"q[{j}]") for j in range(m.nv)]
        qd = [em.var(f"qd[{j}]") for j in range(m.nv)]
        tau = [em.var(f"tau[{j}]") for j in range(m.nv)]
        q2, qd2 = make_spatial_substep(engine)(em, q, qd, tau)
        body, self.n_ops = em.body([x.name for x in q2 + qd2])
        body += [f"q[{j}] = {q2[j].name};" for j in range(m.nv)]
        body += [f"qd[{j}] = {qd2[j].name};" for j in range(m.nv)]
        template = nvcc_build.read_source(TEMPLATE)
        for mark in (NV_MARK, BODY_MARK):
            if template.count(mark) != 1:
                raise ValueError(f"{TEMPLATE} must mark {mark} once")
        self.text = template.replace(NV_MARK, str(m.nv)).replace(
            BODY_MARK, "\n".join("    " + line for line in body))
        self.literals = list(em.literals)


def _check(q, qd, tau, nv):
    tensors = dict(q=q, qd=qd, tau=tau)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"substep_chain: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.dim() != 2 or t.shape != q.shape or t.shape[1] != nv:
            raise ValueError(f"substep_chain: {name} has shape "
                             f"{tuple(t.shape)}, expected (B, {nv}) like q")
        if t.dtype != torch.float32:
            raise ValueError(f"substep_chain: {name} is {t.dtype}, expected "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"substep_chain: {name} is not contiguous")


def substep_chain_plain(engine, n_steps):
    """The plain version of K2: ``chain(q, qd, tau, probe=None) -> (q2,
    qd2)``, the emitted substep run eagerly on (B,) tensors per dof.
    ``probe``, a list, receives each substep's per-contact 0/1 in-contact
    tensors."""
    substep = make_spatial_substep(engine)

    def chain(q, qd, tau, probe=None):
        ops = TorchOps(q[:, 0])
        qs, qds, taus = list(q.unbind(1)), list(qd.unbind(1)), list(
            tau.unbind(1))
        for _ in range(n_steps):
            qs, qds = substep(ops, qs, qds, taus, probe)
        return torch.stack(qs, 1), torch.stack(qds, 1)

    return chain


def substep_chain(engine, n_steps):
    """K2's wrapper for ``engine`` and ``n_steps``: ``chain(q, qd, tau) ->
    (q2, qd2)`` over contiguous (B, nv) float32 tensors on one device. On
    the CPU it runs the plain version; on CUDA it launches K2 (building it
    at the first call) and counts the launch in ``substep_chain.launches``,
    or raises."""
    nv = engine.model.nv
    plain = substep_chain_plain(engine, n_steps)
    kernel = []

    def chain(q, qd, tau):
        _check(q, qd, tau, nv)
        if q.device.type == "cpu":
            return plain(q, qd, tau)
        if q.device.type != "cuda":
            raise ValueError(f"substep_chain: unsupported device {q.device}")
        if not kernel:
            kernel.append(_load(engine))
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = kernel[0](q.data_ptr(), qd.data_ptr(), tau.data_ptr(),
                            q_out.data_ptr(), qd_out.data_ptr(), q.shape[0],
                            n_steps, stream)
        if err != 0:
            raise RuntimeError(f"substep_chain: K2 launch failed with "
                               f"cudaError {err}")
        substep_chain.launches += 1
        return q_out, qd_out

    return chain


substep_chain.launches = 0


def build_job(engine):
    """(name, source, flags) of K2's library for ``engine``, for
    ``nvcc_build.build_all``."""
    return ("substep_chain", SubstepSource(engine).text, NVCC_FLAGS)


def _load(engine):
    lib = nvcc_build.load(nvcc_build.build(*build_job(engine)))
    fn = lib.substep_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
