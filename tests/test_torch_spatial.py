"""K2's plain version (promp_tpu_torch.ops.substep_kernel) against the TPU
kernel promp_tpu.ops.pallas_substep.make_pallas_chain in interpret mode,
on half_cheetah at 5 substeps and B = 8 seeded states drawn as
tests/test_pallas_substep.py's ``_batch`` draws them; and the C source
that K2 is built from.

Tolerances: q rtol 1e-5 / atol 1e-6, qd rtol 1e-4 / atol 1e-4. Both run
the same emitted algebra with the same constant folding and operation
order, so they differ only where XLA and PyTorch round a transcendental
(cos, sin) otherwise, an ulp amplified by the stiff contacts (gaps seen:
2.7e-7 on q, 3.8e-6 on qd); these bars are ten times tighter than the JAX
package's own K2 bars (tests/test_pallas_substep.py:82-85).

The generated CUDA source cannot be compiled here (no nvcc), but its block
functions are plain C: ``test_generated_body_compiled_for_the_host``
compiles them with the host's C++ compiler, where one is installed, runs
them stage by stage as the card's barriers order them, and holds the result
bitwise against the plain version (see ``staged_host_chain``).
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu.envs.mujoco.engine import Engine as JEngine  # noqa: E402
from promp_tpu.envs.mujoco.model import get_model as jget_model  # noqa: E402
from promp_tpu.ops.pallas_substep import make_pallas_chain  # noqa: E402
from promp_tpu_torch.envs.mujoco import spatial  # noqa: E402
from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402
from promp_tpu_torch.envs.mujoco.model import get_model  # noqa: E402
from promp_tpu_torch.ops import substep_kernel as sk  # noqa: E402

N_STEPS, B = 5, 8
Q_TOL = dict(rtol=1e-5, atol=1e-6)
QD_TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(nv, seed, n=B, spread=0.3):
    """Random states as test_pallas_substep.py's ``_batch`` forms them,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = (spread * rng.standard_normal((n, nv))).astype(np.float32)
    q[:, 2] += 0.6
    qd = rng.standard_normal((n, nv)).astype(np.float32)
    tau = (0.5 * rng.standard_normal((n, nv))).astype(np.float32)
    return q, qd, tau


@pytest.fixture(scope="module")
def engine():
    return Engine(get_model("half_cheetah"))


@pytest.fixture(scope="module")
def source(engine):
    return sk.SubstepSource(engine)


def test_plain_chain_matches_pallas_kernel(engine):
    q, qd, tau = _batch(9, 0)
    chain = make_pallas_chain(JEngine(jget_model("half_cheetah")), N_STEPS,
                              tile=128, interpret=True)
    qj, qdj = (np.asarray(a) for a in chain(q, qd, tau))
    probe = []
    qp, qdp = sk.substep_chain_plain(engine, N_STEPS)(
        torch.tensor(q), torch.tensor(qd), torch.tensor(tau), probe)
    assert np.isfinite(qj).all() and np.isfinite(qdj).all()
    np.testing.assert_allclose(qp.numpy(), qj, **Q_TOL)
    np.testing.assert_allclose(qdp.numpy(), qdj, **QD_TOL)
    # one probe per contact and substep, and the contacts do act
    assert len(probe) == 24 * N_STEPS
    assert float(sum(p.sum() for p in probe)) > 10


def test_wrapper_runs_the_plain_version_on_the_cpu(engine):
    q, qd, tau = (torch.tensor(a) for a in _batch(9, 1))
    sk.substep_chain.launches = 0
    got = sk.substep_chain(engine, N_STEPS)(q, qd, tau)
    want = sk.substep_chain_plain(engine, N_STEPS)(q, qd, tau)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sk.substep_chain.launches == 0


def test_wrapper_rejects_bad_inputs(engine):
    chain = sk.substep_chain(engine, N_STEPS)
    q = torch.zeros((4, 9))
    with pytest.raises(ValueError, match="expected \\(B, 9\\)"):
        chain(q, q, torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="float32"):
        chain(q, q.double(), q)
    with pytest.raises(ValueError, match="not contiguous"):
        chain(q, torch.zeros((9, 4)).t(), q)
    with pytest.raises(ValueError, match="several devices"):
        chain(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="unsupported device"):
        chain(q.to("meta"), q.to("meta"), q.to("meta"))


def test_nan_propagates_as_in_jax(engine):
    q, qd, tau = (torch.tensor(a) for a in _batch(9, 2, n=2))
    qd[1, 4] = float("nan")
    q2, qd2 = sk.substep_chain_plain(engine, 1)(q, qd, tau)
    assert torch.isfinite(q2[0]).all() and torch.isfinite(qd2[0]).all()
    assert torch.isnan(qd2[1]).any()


def test_c_literals_parse_back_to_their_float32(source):
    assert len(source.literals) > 100
    extra = [(v, spatial.c_float(v)) for v in
             (0.1, -9.81, 1e-8, 1e-12, 300.0, 0.0, -0.0, 1 / 3, 3.4e38)]
    for value, lit in source.literals + extra:
        assert re.fullmatch(r"\(?-?\d\.\d*e[+-]\d+f\)?", lit), lit
        assert np.float32(lit.strip("()")[:-1]) == np.float32(value), lit
    with pytest.raises(ValueError, match="not finite"):
        spatial.c_float(1e39)


def test_source_is_one_kernel_with_the_body_filled_in(source):
    text = source.text
    assert isinstance(text, str)
    assert text.count("__global__") == 1
    assert text.count('extern "C"') == 2    # the launch, the shared bytes
    assert "/*@" not in text and "constexpr int kNv = 9;" in text
    assert f"constexpr int kParts = {sk.PARTS};" in text
    sched = source.schedule
    # a function for each (stage, part) with operations ...
    funcs = re.findall(r"void block_(\d+)_(\d+)\([^)]*\) \{\n(.*?)\n\}", text,
                       re.S)
    assert [(int(k), int(p)) for k, p, _ in funcs] == [
        (k, p) for k, stage in enumerate(sched.blocks)
        for p, block in enumerate(stage) if block]
    # ... called from its part's case in stage order, with one barrier
    # after every stage
    cases = re.findall(r"case (\d+):\n(.*?)break;", text, re.S)
    assert [int(p) for p, _ in cases] == list(range(sk.PARTS))
    for p, case in cases:
        steps = re.findall(r"block_(\d+)_%s\(|(stage_barrier)\(\)" % p, case)
        stage, want = 0, []
        for k, stage_ops in enumerate(sched.blocks):
            if stage_ops[int(p)]:
                want.append((str(k), ""))
            want.append(("", "stage_barrier"))
        assert steps == want
    # each block is single-assignment and defines every temporary before
    # it reads it; across the blocks every live operation is computed
    # exactly once (the other definitions load a slot, a register or a
    # constant)
    computed = []
    for _, _, body in funcs:
        defs = re.findall(r"const float (t\d+) = (.*);", body)
        names = [d for d, _ in defs]
        assert len(names) == len(set(names))
        seen = set()
        for name, expr in defs:
            assert set(re.findall(r"\bt\d+\b", expr)) <= seen, name
            seen.add(name)
            loaded = r"s\[\d+\]\[lane\]|r\[\d+\]|\(?-?[\d.]+e[+-]\d+f\)?"
            if not re.fullmatch(loaded, expr):
                computed.append(name)
    assert len(computed) == len(set(computed)) == len(sched.part_of)
    assert 3000 < source.n_ops < 5000


def test_spatial_ok():
    assert not spatial.spatial_ok(get_model("swimmer"))
    for name in ("half_cheetah", "hopper", "walker2d", "ant", "humanoid"):
        assert spatial.spatial_ok(get_model(name)), name
    with pytest.raises(ValueError, match="not spatial_ok"):
        spatial.make_spatial_substep(Engine(get_model("swimmer")))


# The host build of a scheduled source: its block functions and row copies
# as plain C++ (the barrier, the kernel and its launch cut), and an entry
# that runs a block's stages in order, every (warp, lane) of a stage in
# turn (parts ascending, or descending with ``reverse``), with the shared
# rows poisoned with NaN before each block. A read of another part's same-stage value, or
# of a slot before its write, then changes the result with the order. cosf
# and sinf are taken in float64 and rounded once, as ``pinned`` makes the
# plain version take them (and sqrt: torch's CPU float32 sqrt is not always
# correctly rounded, while the host's sqrtf, like the card's, is), so that
# the host build and the plain version compute every operation alike and can
# be held bitwise.
_HOST_PRELUDE = """#include <math.h>
#include <stddef.h>
#define __device__
#define __forceinline__ inline
#define cosf(x) ((float)cos((double)(x)))
#define sinf(x) ((float)sin((double)(x)))
"""

_HOST_ENTRY = """
extern "C" void host_chain(const float* q_in, const float* qd_in,
                           const float* tau_in, const float* mods_in,
                           float* q_out, float* qd_out, int batch,
                           int n_steps, int reverse) {
  static Row sh[kRows];
  static float regs[kParts][kLanes][kRegs > 0 ? kRegs : 1];
  for (int env0 = 0; env0 < batch; env0 += kLanes) {
    for (int i = 0; i < kRows; ++i)
      for (int l = 0; l < kLanes; ++l) sh[i][l] = NAN;
    for (int tid = 0; tid < kThreads; ++tid)
      load_rows(tid, env0, batch, q_in, qd_in, tau_in, mods_in, sh);
    Row* s = sh + kRowS;
    const Row* tau = sh + kRowTau;
    const Row* m = sh + kRowM;
    for (int step = 0; step < n_steps; ++step) {
      const Row* x = sh + (step & 1 ? kRowX1 : kRowX0);
      Row* y = sh + (step & 1 ? kRowX0 : kRowX1);
@STAGES@
    }
    for (int tid = 0; tid < kThreads; ++tid)
      store_rows(tid, env0, batch, sh + (n_steps & 1 ? kRowX1 : kRowX0),
                 q_out, qd_out);
  }
}
"""

_HOST_STAGE = """      for (int w = 0; w < kParts; ++w) {
        const int part = reverse ? kParts - 1 - w : w;
        for (int lane = 0; lane < kLanes; ++lane) {
          float* r = regs[part][lane];
          switch (part) {
@CASES@
          }
        }
      }"""


SENTINEL = 12345.0


@pytest.fixture
def pinned(monkeypatch):
    """The plain version with cos, sin and sqrt taken in float64 and
    rounded once to float32, as the host build takes them."""
    for fn in ("cos", "sin", "sqrt"):
        f = getattr(torch, fn)
        monkeypatch.setattr(spatial.TorchOps, fn, staticmethod(
            lambda x, f=f: f(x.double()).float()))


def staged_host_chain(source, tmp_path):
    """``chain(q, qd, tau, mods, n_steps, reverse) -> (q2, qd2)`` over
    numpy arrays: ``source`` built for the host with the entry above, its
    outputs one row longer than the batch and filled with ``SENTINEL``;
    raises if the padded lanes wrote that row. Skips without a host C++
    compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = source.text.replace("#include <cuda_runtime.h>", _HOST_PRELUDE)
    stages = "\n".join(_HOST_STAGE.replace("@CASES@", "\n".join(
        f"            case {p}: " + sk.BLOCK_CALL.format(k=k, p=p) + " break;"
        for p, block in enumerate(stage) if block))
        for k, stage in enumerate(source.schedule.blocks))
    cut = text.index("__device__ __forceinline__ void stage_barrier()")
    rest = text[cut:]
    rest = rest[rest.index("\n}\n") + 3:]         # past stage_barrier's body
    text = text[:cut] + rest
    text = (text[:text.index("__global__")] + "}  // namespace\n"
            + _HOST_ENTRY.replace("@STAGES@", stages))
    cpp, lib_path = tmp_path / "staged.cpp", tmp_path / "libstaged.so"
    cpp.write_text(text)
    subprocess.run([cxx, "-O0", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(lib_path), str(cpp)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    def chain(q, qd, tau, mods, n_steps, reverse):
        b, nv = q.shape
        q2 = np.full((b + 1, nv), SENTINEL, np.float32)
        qd2 = np.full((b + 1, nv), SENTINEL, np.float32)
        lib.host_chain(ptr(q), ptr(qd), ptr(tau), ptr(mods), ptr(q2),
                       ptr(qd2), b, n_steps, int(reverse))
        if not ((q2[b] == SENTINEL).all() and (qd2[b] == SENTINEL).all()):
            raise AssertionError("a padded lane wrote past the batch")
        return q2[:b], qd2[:b]

    return chain


def check_staged_source(source, chain_plain, q, qd, tau, mods, tmp_path):
    """Holds the host build of ``source`` bitwise against ``chain_plain``
    (the pinned plain version) on one ragged batch with a NaN row, in both
    part orders."""
    b = q.shape[0]
    assert b % 32 and b > 32
    qd = qd.copy()
    qd[b - 1, 4] = np.nan
    staged = staged_host_chain(source, tmp_path)
    ins = [torch.tensor(a) for a in (q, qd, tau)] + (
        [] if mods is None else [torch.tensor(mods)])
    qp, qdp = (a.numpy() for a in chain_plain(*ins))
    assert np.isnan(qdp[-1]).any() and np.isfinite(qdp[:-1]).all()
    for reverse in (False, True):
        q2, qd2 = staged(q, qd, tau, mods, N_STEPS, reverse)
        np.testing.assert_array_equal(q2, qp)
        np.testing.assert_array_equal(qd2, qdp)


def test_generated_body_compiled_for_the_host(source, engine, pinned,
                                              tmp_path):
    """K2's scheduled half_cheetah source built for the host and run stage
    by stage: the C back end's syntax, operator order, literals and
    NaN-propagating max/min, the schedule's slots, registers and barriers,
    and the ragged edge, held bitwise against the plain version at B = 37
    (two blocks, 27 padded lanes)."""
    q, qd, tau = _batch(9, 3, n=37)
    check_staged_source(source, sk.substep_chain_plain(engine, N_STEPS), q,
                        qd, tau, None, tmp_path)
