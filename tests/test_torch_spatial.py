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

The generated CUDA source cannot be compiled here (no nvcc), but its body
is plain C: ``test_generated_body_compiled_for_the_host`` compiles it
with the host's C++ compiler, where one is installed, and holds it against
the plain version at the same bars.
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
    assert text.count('extern "C"') == 1
    assert "/*@" not in text and "constexpr int kNv = 9;" in text
    defs = re.findall(r"const float (t\d+) = (.*);", text)
    names = [d for d, _ in defs]
    assert len(names) == len(set(names)) == len(defs)
    # single assignment, each temporary defined before it is read
    seen = set()
    for name, expr in defs:
        assert set(re.findall(r"\bt\d+\b", expr)) <= seen, name
        seen.add(name)
    # every temporary is live (the emitter drops dead lines)
    reads = set(re.findall(r"\bt\d+\b", " ".join(e for _, e in defs)))
    outs = set(re.findall(r"qd?\[\d\] = (t\d+);", text))
    assert set(names) == reads | outs
    assert 3000 < source.n_ops < 5000


def test_spatial_ok():
    assert not spatial.spatial_ok(get_model("swimmer"))
    for name in ("half_cheetah", "hopper", "walker2d", "ant", "humanoid"):
        assert spatial.spatial_ok(get_model(name)), name
    with pytest.raises(ValueError, match="not spatial_ok"):
        spatial.make_spatial_substep(Engine(get_model("swimmer")))


_HOST_PRELUDE = """#include <math.h>
#include <stddef.h>
struct Idx { int x; };
static Idx blockIdx, threadIdx, blockDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
"""

_HOST_ENTRY = """
extern "C" void host_chain(const float* q, const float* qd,
                           const float* tau, float* q_out, float* qd_out,
                           int batch, int n_steps) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int i = 0; i < batch; ++i) {
    blockIdx.x = i;
    substep_chain_kernel(q, qd, tau, q_out, qd_out, batch, n_steps);
  }
}
"""


def test_generated_body_compiled_for_the_host(source, engine, tmp_path):
    """K2's source with the CUDA launch replaced by a host loop over the
    envs, compiled without contraction (as nvcc's -fmad=false): the C back
    end's syntax, operator order, literals and NaN-propagating max/min,
    held against the plain version."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = source.text.replace("#include <cuda_runtime.h>", _HOST_PRELUDE)
    text = text[:text.index('extern "C"')] + _HOST_ENTRY
    (tmp_path / "k2_host.cpp").write_text(text)
    lib_path = tmp_path / "libk2_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(lib_path), str(tmp_path / "k2_host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    q, qd, tau = _batch(9, 3)
    qd[B - 1, 4] = np.nan
    q_out, qd_out = np.empty_like(q), np.empty_like(qd)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.host_chain(ptr(q), ptr(qd), ptr(tau), ptr(q_out), ptr(qd_out), B,
                   N_STEPS)
    qp, qdp = sk.substep_chain_plain(engine, N_STEPS)(
        torch.tensor(q), torch.tensor(qd), torch.tensor(tau))
    np.testing.assert_allclose(q_out[:-1], qp.numpy()[:-1], **Q_TOL)
    np.testing.assert_allclose(qd_out[:-1], qdp.numpy()[:-1], **QD_TOL)
    assert np.isnan(qd_out[-1]).any() and torch.isnan(qdp[-1]).any()
