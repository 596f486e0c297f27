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

K2 and K3 are one CUDA template, ``csrc/substep_chain.cu``, filled in for
a model (and K3's mod keys): the substep generated from the model spec by
the spatial emitter's C back end (every model constant folded in, and in
K3 the multiplied ones read from the env's mods row), split by
ops/substep_schedule.py into parts, one warp each, and stages separated by
block barriers, one env per lane. At the first CUDA call for a model the
filled-in source is compiled with nvcc into a shared library with a plain
C entry point (ops/nvcc_build.py) and loaded with ``ctypes``; never at
import.

The schedule's figures for a body, on the CPU::

    python -m promp_tpu_torch.ops.substep_kernel walker2d --mods
"""
from __future__ import annotations

import ctypes
import re
import sys

import torch

from promp_tpu_torch.envs.mujoco.spatial import (
    MOD_BASE_NDIM, CEmitter, TorchOps, make_spatial_substep, mod_rows,
    unpack_mods)
from promp_tpu_torch.ops import nvcc_build
from promp_tpu_torch.ops.substep_schedule import Schedule

TEMPLATE = "substep_chain.cu"
MARKS = ("NV", "NM", "NPARTS", "SLOTS", "REGS", "BLOCKS", "PARTS")
# warps a block (parts of the schedule), each with 32 envs, one a lane,
# and the least weight a part may take in a stage (ops/substep_schedule.py)
PARTS, MIN_CAP = 8, 16
# -fmad=false: no multiply-add contraction, so K2 and K3 round op for op
# like their plain version (csrc/substep_chain.cu); -Xptxas -v reports
# registers, spills and shared memory in the build log
NVCC_FLAGS = nvcc_build.BASE_FLAGS + ("-fmad=false", "-Xptxas=-v")
_INPUT = re.compile(r"\b(q|qd|tau|m)\[(\d+)\]")
_BLOCK_ARGS = ("int lane, float* __restrict__ r, Row* __restrict__ s, "
               "const Row* __restrict__ q, const Row* __restrict__ qd, "
               "const Row* __restrict__ tau, const Row* __restrict__ m, "
               "Row* __restrict__ q2, Row* __restrict__ qd2")
BLOCK_CALL = "block_{k}_{p}(lane, r, s, x, x + kNv, tau, m, y, y + kNv);"


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
    """K2's CUDA source for one engine, or K3's with ``mod_keys``, split
    over PARTS warps: ``text``, the emitted body's ``n_ops`` float
    operations a substep, the (constant, literal) pairs it wrote, ``nm``,
    and ``schedule`` (ops/substep_schedule.py) with its figures,
    ``stats``."""

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
        outputs = [int(x.name[1:]) for x in q2 + qd2]
        sched = Schedule(em.lines, outputs, PARTS, MIN_CAP)
        self.schedule, self.n_ops = sched, sched.n_ops
        self.stats = sched.stats()
        self.literals = list(em.literals)
        blocks = [_block_source(k, p, block, sched, em.lines, m.nv)
                  for k, stage in enumerate(sched.blocks)
                  for p, block in enumerate(stage) if block]
        marks = dict(NV=m.nv, NM=self.nm, NPARTS=PARTS, SLOTS=sched.n_slots,
                     REGS=sched.n_regs, BLOCKS="\n\n".join(blocks),
                     PARTS="\n".join(_part_source(p, sched.blocks)
                                     for p in range(PARTS)))
        text = nvcc_build.read_source(TEMPLATE)
        for mark in MARKS:
            tag = f"/*@{mark}@*/"
            if text.count(tag) != 1:
                raise ValueError(f"{TEMPLATE} must mark {tag} once")
            text = text.replace(tag, str(marks[mark]))
        self.text = text


def _block_source(k, p, block, sched, lines, nv):
    """The C function ``block_k_p``: part p's operations of stage k, which
    reads what they take from elsewhere (a constant, a shared slot or a
    register), computes them in order, and writes the slots, registers and
    next-state rows that later readers take."""
    out_rows = {}
    for j, i in enumerate(sched.outputs):
        out_rows.setdefault(i, []).append(
            f"q2[{j}]" if j < nv else f"qd2[{j - nv}]")
    known, body, head = set(block), [], []
    for i in block:
        for d in lines[i][2]:
            if d in known:
                continue
            known.add(d)
            if d in sched.consts:
                src = lines[d][0]
            elif d in sched.slot_of:
                src = f"s[{sched.slot_of[d]}][lane]"
            else:
                src = f"r[{sched.reg_of[d]}]"
            head.append(f"const float t{d} = {src};")
        expr = _INPUT.sub(r"\1[\2][lane]", lines[i][0])
        body.append(f"const float t{i} = {expr};")
    tail = []
    for i in block:
        if i in sched.slot_of:
            tail.append(f"s[{sched.slot_of[i]}][lane] = t{i};")
        elif i in sched.reg_of:
            tail.append(f"r[{sched.reg_of[i]}] = t{i};")
        tail += [f"{row}[lane] = t{i};" for row in out_rows.get(i, ())]
    return (f"__device__ __forceinline__ void block_{k}_{p}({_BLOCK_ARGS}) "
            "{\n" + "".join(f"  {line}\n" for line in head + body + tail)
            + "}")


def _part_source(p, blocks):
    """Part p's case of the kernel: the substep loop over its blocks, a
    stage barrier after each stage (also where it has no operations)."""
    lines = [f"    case {p}:", "#pragma unroll 1",
             "      for (int step = 0; step < n_steps; ++step) {",
             "        const Row* const x = sh + (step & 1 ? kRowX1 : kRowX0);",
             "        Row* const y = sh + (step & 1 ? kRowX0 : kRowX1);"]
    for k, stage in enumerate(blocks):
        if stage[p]:
            lines.append("        " + BLOCK_CALL.format(k=k, p=p))
        lines.append("        stage_barrier();")
    return "\n".join(lines + ["      }", "      break;"])


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
            kernel.append(load_launch(engine, mod_keys))
        q_out, qd_out = torch.empty_like(q), torch.empty_like(q)
        mods = ins[3].data_ptr() if mod_keys else None
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = kernel[0](*[t.data_ptr() for t in ins[:3]], mods,
                            q_out.data_ptr(), qd_out.data_ptr(), q.shape[0],
                            n_steps, stream)
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


def build_job(source):
    """(name, source text, flags) of a ``SubstepSource``'s library (K2's,
    or K3's when it reads mods) for ``nvcc_build.build_all``."""
    name = "substep_chain_mods" if source.nm else "substep_chain"
    return (name, source.text, NVCC_FLAGS)


def load_launch(engine, mod_keys=()):
    """The library's C entry point ``substep_chain_launch(q, qd, tau, mods,
    q_out, qd_out, batch, n_steps, stream)`` through ctypes, built first if
    needed; ``mods`` is None for K2. Returns a cudaError_t."""
    lib = nvcc_build.load(nvcc_build.build(*build_job(
        SubstepSource(engine, mod_keys))))
    fn = lib.substep_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None):
    """Prints the schedule's figures (``SubstepSource.stats``) of a body's
    K2, or K3 with ``--mods``, as one JSON line."""
    import argparse
    import json

    from promp_tpu_torch.envs.mujoco.engine import Engine
    from promp_tpu_torch.envs.mujoco.model import get_model

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("body", help="model name, e.g. walker2d")
    ap.add_argument("--mods", action="store_true",
                    help="K3 with the four rand-params mod keys")
    args = ap.parse_args(argv)
    keys = tuple(sorted(MOD_BASE_NDIM)) if args.mods else ()
    src = SubstepSource(Engine(get_model(args.body)), keys)
    print(json.dumps(dict(body=args.body, mod_keys=keys, **src.stats)))


if __name__ == "__main__":
    sys.exit(main())
