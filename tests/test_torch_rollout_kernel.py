"""K1's plain version (promp_tpu_torch.ops.rollout_kernel) against the
Pallas kernel promp_tpu.ops.pallas_rollout in interpret mode, as
tests/test_pallas.py runs it, at 3 tasks x 8 envs x 25 steps with the same
noise (drawn as pallas_rollout.py:112 draws it).

Tolerances (float32): obs, actions and means atol 1e-4 over the 25-step
trajectory (matmul summation order differs; the error compounds through
the state), per-step quantities 1e-5; rewards 1e-5 where both take the
same branch. A branch flip is allowed only at a float tie (tie margin
under 1e-5) or where the reference zeroes a reward the port pays at its
goal corner (see test_torch_support.py), and flips are counted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import (  # noqa: E402,F401
    check_reward_flips, torch_single_thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from promp_tpu.ops.pallas_rollout import pallas_pointmass_rollout  # noqa: E402
from promp_tpu.policies.gaussian_mlp import GaussianMLPPolicy  # noqa: E402
from promp_tpu_torch.ops import nvcc_build  # noqa: E402
from promp_tpu_torch.ops import rollout_kernel as rk  # noqa: E402
from promp_tpu_torch.weights import from_numpy_params  # noqa: E402

N_T, N_E, T = 3, 8, 25
TRAJ, STEP = 1e-4, 1e-5
SENTINEL = 12345.0   # fills output rows past the rollout


@pytest.fixture(scope="module")
def runs():
    policy = GaussianMLPPolicy(obs_dim=2, action_dim=2, hidden_sizes=(64, 64))
    tp = dict(policy.replicate(policy.init(jax.random.PRNGKey(0)), N_T))
    # per-task output biases drive the point out of the L1 dead zone, so
    # both reward branches are taken
    tp["mean_network/output/bias"] = jnp.array(
        [[6.0, 5.0], [-7.0, 4.0], [3.0, -6.0]], jnp.float32)
    tp["log_std_network/log_std_var"] = jnp.array(
        [[[0.0, -0.5]], [[0.3, 0.1]], [[-1.0, 0.0]]], jnp.float32)
    goals = jnp.array([[2.0, 2.0], [-2.0, 2.0], [-2.0, -2.0]], jnp.float32)
    obs0 = jax.random.uniform(jax.random.PRNGKey(2), (N_T, N_E, 2),
                              jnp.float32, -0.2, 0.2)
    key = jax.random.PRNGKey(9)
    want = pallas_pointmass_rollout(tp, goals, obs0, key, horizon=T,
                                    interpret=True)
    noise = jax.random.normal(key, (N_T, T, N_E, 2), jnp.float32)
    args = (from_numpy_params({k: np.asarray(v) for k, v in tp.items()},
                              "cpu"),
            torch.tensor(np.asarray(goals)), torch.tensor(np.asarray(obs0)),
            torch.tensor(np.asarray(noise)))
    return args, rk.pointmass_rollout(*args), want


def test_trajectory_matches_pallas(runs):
    _, got, want = runs
    for k, tol in (("observations", TRAJ), ("actions", TRAJ)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, rtol=0, err_msg=k)
    for k in ("mean", "log_std"):
        np.testing.assert_allclose(got["agent_infos"][k].numpy(),
                                   np.asarray(want["agent_infos"][k]),
                                   atol=TRAJ, rtol=0, err_msg=k)
    # step by step: each step's mean from that step's obs agrees per op
    err = (got["actions"] - got["agent_infos"]["mean"]).numpy() - (
        np.asarray(want["actions"]) - np.asarray(want["agent_infos"]["mean"]))
    assert np.abs(err).max() < STEP


def test_rewards_match_where_the_branch_agrees(runs):
    args, got, want = runs
    g, w = got["rewards"].numpy(), np.asarray(want["rewards"])
    flips = check_reward_flips(got, w, args[1])
    np.testing.assert_allclose(g[~flips], w[~flips], atol=STEP, rtol=0)
    # a handful of goal-corner flips in 600 steps are expected (1 at this
    # seed)
    assert flips.sum() <= 3, f"{flips.sum()} reward-branch flips"
    assert 0.2 < (w != 0).mean() < 0.9  # both branches exercised


def test_cpu_runs_the_plain_version_and_counts_no_launch(runs):
    args, got, _ = runs
    before = rk.pointmass_rollout.launches
    plain = rk.pointmass_rollout_plain(*args)
    again = rk.pointmass_rollout(*args)
    assert rk.pointmass_rollout.launches == before
    for k in ("observations", "actions", "rewards"):
        assert torch.equal(plain[k], got[k]) and torch.equal(again[k], got[k])
    assert got["observations"].shape == (N_T, N_E, T, 2)
    assert got["rewards"].shape == (N_T, N_E, T)


def test_wrapper_rejects_bad_inputs(runs):
    (params, goals, obs0, noise), _, _ = runs
    with pytest.raises(ValueError, match="shape"):
        rk.pointmass_rollout(params, goals, obs0, noise[:, :, :4])
    with pytest.raises(ValueError, match="float32"):
        rk.pointmass_rollout(params, goals.double(), obs0, noise)
    with pytest.raises(ValueError, match="contiguous"):
        rk.pointmass_rollout(params, goals, obs0,
                             noise.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="devices"):
        rk.pointmass_rollout(params, goals.to("meta"), obs0, noise)
    # the kernel's limits: the grid's env groups and a block's shared
    # memory (K1 takes any number of envs up to 65535 groups)
    too_many = rk.MAX_GROUPS * rk.ENVS_PER_BLOCK + 1
    with pytest.raises(ValueError, match=f"{too_many} envs"):
        rk.launch_geometry(1, too_many, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        rk.launch_geometry(1, 20, 256, 256)
    with pytest.raises(ValueError, match="launch on cpu"):
        rk.bind_launch(params, goals, obs0, noise, [torch.empty(0)] * 4)


def test_missing_nvcc_names_the_search(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent/cuda")
    monkeypatch.setattr(nvcc_build.os, "access", lambda *a: False)
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda *a: None)
    with pytest.raises(RuntimeError, match="/nonexistent/cuda/bin/nvcc.*"
                       "/usr/local/cuda/bin/nvcc.*PATH"):
        nvcc_build.find_nvcc()


def test_tie_margin():
    goals = torch.tensor([[2.0, 2.0]])
    # the new position x = 0 is equidistant from the goal (2, 2) and the
    # corner (-2, 2); an action of 5 moves by +0.1 after the affine
    tie = rk.reward_tie_margin(torch.tensor([[[[-0.1, 1.5]]]]),
                               torch.tensor([[[[5.0, 0.0]]]]), goals)
    # far from the radius; the nearest corner (-2, 2) is not the goal
    clear = rk.reward_tie_margin(torch.tensor([[[[-1.0, 1.0]]]]),
                                 torch.tensor([[[[0.0, 0.0]]]]), goals)
    # the goal is the nearest corner by far: K1's comparison of the goal's
    # distance with the goal corner's is no tie
    at_goal = rk.reward_tie_margin(torch.tensor([[[[1.5, 1.5]]]]),
                                   torch.tensor([[[[0.0, 0.0]]]]), goals)
    assert float(tie) < 1e-6 and float(clear) > 0.1
    assert float(at_goal) > 2.0


@pytest.mark.parametrize("n_envs", [1, 19, 20, 33, 1025])
def test_launch_geometry_covers_every_env_once(n_envs):
    """The launch's grid runs every (task, env) in exactly one warp of one
    block; only the last group has empty warps; the block fits."""
    geo = rk.launch_geometry(N_T, n_envs, 64, 64)
    tasks, groups = geo.grid
    e = geo.envs_per_block
    seen = np.zeros((N_T, n_envs), int)
    for task in range(tasks):
        for g in range(groups):
            for warp in range(geo.threads // 32):
                if g * e + warp < n_envs:
                    seen[task, g * e + warp] += 1
    assert (seen == 1).all()
    assert 0 <= groups * e - n_envs < e
    assert geo.threads == 32 * e and geo.units_per_lane == 2
    assert geo.w2_in_registers and geo.shared_bytes <= 227 * 1024
    # W2 columns past REGISTER_WEIGHTS_MAX a lane go to shared memory
    wide = rk.launch_geometry(N_T, n_envs, 192, 96)
    assert wide.units_per_lane == 3 and not wide.w2_in_registers
    assert 4 * 192 * 96 < wide.shared_bytes <= 227 * 1024


# csrc/rollout_kernel.cu built for the host: the CUDA built-ins as plain
# C++, every thread of a block a host thread, __syncthreads a barrier of the
# block's threads and __syncwarp one of the warp's, the block's shared
# memory poisoned with NaN before each block (a read of a value before its
# write, or of padding, then shows), the launch cut and an entry that runs
# the grid block by block.
_HOST_PRELUDE = r"""#include <math.h>
#include <stddef.h>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
static inline float2 make_float2(float x, float y) { return {x, y}; }
struct Index { int x, y; };
static thread_local Index threadIdx;
static Index blockIdx;
static std::barrier<>* block_barrier;
static std::barrier<>* warp_barriers[32];
static inline void __syncthreads() { block_barrier->arrive_and_wait(); }
static inline void __syncwarp() {
  warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
constexpr int kHostSmem = 1 << 14;
alignas(16) static float4 host_smem[kHostSmem];
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
"""

_HOST_ENTRY = r"""
extern "C" void host_rollout(
    const float* goals, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, const float* log_std,
    const float* obs0, const float* noise, float* obs_out, float* act_out,
    float* rew_out, float* mean_out, int n_tasks, int n_envs, int horizon) {
  std::barrier<> bar(kThreads);
  block_barrier = &bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < kThreads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    warp_barriers[w] = warps.back().get();
  }
  for (int task = 0; task < n_tasks; ++task) {
    for (int g = 0; g < (n_envs + kE - 1) / kE; ++g) {
      blockIdx = {task, g};
      for (int i = 0; i < kHostSmem; ++i)
        host_smem[i] = {NAN, NAN, NAN, NAN};
      std::vector<std::thread> threads;
      for (int j = 0; j < kThreads; ++j)
        threads.emplace_back([=] {
          threadIdx = {j, 0};
          pointmass_rollout_kernel(goals, w1, b1, w2, b2, w3, b3, log_std,
                                   obs0, noise, obs_out, act_out, rew_out,
                                   mean_out, n_envs, horizon);
        });
      for (auto& t : threads) t.join();
    }
  }
}
"""


def _defines(h0, h1):
    """The -DK1_* flags of ``rk.build_job`` for this build."""
    return [f for f in rk.build_job(h0, h1)[2] if f.startswith("-DK1_")]


def _host_sources(jobs, tmp_path):
    """Builds K1's source for the host once per ``{label: -D flags}`` of
    ``jobs``, all g++ processes at once; returns {label: ctypes entry}.
    Skips without a host C++ compiler."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = nvcc_build.read_source(rk.SOURCE)
    text = text[:text.index('extern "C" int pointmass_rollout_launch(')]
    text = text.replace("#include <cuda_runtime.h>", _HOST_PRELUDE).replace(
        "extern __shared__ float4 smem4[];", "float4* smem4 = host_smem;")
    cpp = tmp_path / "k1_host.cpp"
    cpp.write_text(text + _HOST_ENTRY)
    procs = {}
    for i, (label, defines) in enumerate(jobs.items()):
        lib = tmp_path / f"libk1_{i}.so"
        procs[label] = (lib, subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", *defines, "-o", str(lib), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        built = ctypes.CDLL(str(lib))
        fn = built.host_rollout
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
        fn.shared_bytes = built.pointmass_rollout_shared_bytes()
        entries[label] = fn
    return entries


def _host_run(entry, task_params, goals, obs0, noise):
    """The host build's rollout of torch CPU inputs, its outputs one row
    longer than the rollout's and filled with SENTINEL; raises if an empty
    env slot wrote that row."""
    n_tasks, n_envs, horizon = noise.shape[0], noise.shape[2], noise.shape[1]
    n = n_tasks * n_envs * horizon
    outs = [torch.full((size + width,), SENTINEL) for size, width in
            ((2 * n, 2), (2 * n, 2), (n, 1), (2 * n, 2))]
    w1, b1, w2, b2, w3, b3, log_std = rk._unpack(task_params)
    ins = (goals, w1, b1, w2, b2, w3, b3, log_std.contiguous(), obs0, noise)
    entry(*(t.data_ptr() for t in ins + tuple(outs)), n_tasks, n_envs,
          horizon)
    assert all(bool((o[-w:] == SENTINEL).all())
               for o, w in zip(outs, (2, 2, 1, 2))), "wrote past the rollout"
    obs, act, rew, mean = (o[:-w] for o, w in zip(outs, (2, 2, 1, 2)))
    shape = (n_tasks, n_envs, horizon)
    return rk._result(obs.view(shape + (2,)), act.view(shape + (2,)),
                      rew.view(shape), mean.view(shape + (2,)),
                      log_std.contiguous())


def _hold_host_against_plain(host, plain):
    """The plain version's bars (as test_trajectory_matches_pallas and
    test_rewards_match_where_the_branch_agrees hold it to Pallas)."""
    for k in ("observations", "actions"):
        np.testing.assert_allclose(host[k], plain[k], atol=TRAJ, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(host["agent_infos"]["mean"],
                               plain["agent_infos"]["mean"], atol=TRAJ,
                               rtol=0)
    flips = (host["rewards"] == 0) != (plain["rewards"] == 0)
    np.testing.assert_allclose(host["rewards"][~flips],
                               plain["rewards"][~flips], atol=STEP, rtol=0)
    assert int(flips.sum()) <= 3


def _odd_envs(args, n_envs):
    """``args`` cut to their first ``n_envs`` envs."""
    params, goals, obs0, noise = args
    return (params, goals, obs0[:, :n_envs].contiguous(),
            noise[:, :, :n_envs].contiguous())


def test_cuda_source_on_the_host_at_the_main_widths(runs, tmp_path):
    """K1's CUDA source, run on the host as its grid of blocks of threads,
    at (64, 64) on 3 tasks x 7 envs (groups of 2, the last with one empty
    warp) x 25 steps: within the bars of its plain version, every output
    written once and nothing past the rollout."""
    args, _, _ = runs
    args = _odd_envs(args, 7)
    (entry,) = _host_sources({"main": _defines(64, 64)}, tmp_path).values()
    # the source's shared layout is the one launch_geometry reserves
    geo = rk.launch_geometry(N_T, 7, 64, 64)
    assert geo.grid == (N_T, 4) and entry.shared_bytes == geo.shared_bytes
    _hold_host_against_plain(_host_run(entry, *args),
                             rk.pointmass_rollout_plain(*args))


def test_cuda_source_on_the_host_rounds_alike_with_w2_in_shared_memory(
        runs, monkeypatch, tmp_path):
    """At widths (42, 38), no multiple of 4 and a lane's second unit past
    the width in some lanes, on 5 envs a task (the last group ragged) over
    70 steps, the host build with W2 in registers and with W2 in shared
    memory (forced by lowering REGISTER_WEIGHTS_MAX) gives bitwise the same
    rollout: each unit's sum runs in one order wherever its weights sit;
    and it keeps to the plain version's bars."""
    (_, goals, _, _), _, _ = runs
    rng = np.random.default_rng(4)
    # 70 steps: two chunks of 32 written out in full, and 6 steps at the
    # end
    obs0 = torch.tensor(rng.uniform(-0.2, 0.2, (N_T, 5, 2)),
                        dtype=torch.float32)
    noise = torch.tensor(rng.normal(size=(N_T, 70, 5, 2)),
                         dtype=torch.float32)
    shapes = {k: s for k, s in zip(rk.PARAM_KEYS, (
        (2, 42), (42,), (42, 38), (38,), (38, 2), (2,), (1, 2)))}
    params = {k: torch.tensor(rng.normal(0.0, 0.5, (N_T,) + s),
                              dtype=torch.float32) for k, s in shapes.items()}
    params["mean_network/output/bias"] = torch.tensor(
        [[6.0, 5.0], [-7.0, 4.0], [3.0, -6.0]])
    plain = rk.pointmass_rollout_plain(params, goals, obs0, noise)
    jobs = {"registers": _defines(42, 38)}
    with monkeypatch.context() as m:
        m.setattr(rk, "REGISTER_WEIGHTS_MAX", 8)
        jobs["shared_w2"] = _defines(42, 38)
    assert "-DK1_W2_REG=1" in jobs["registers"]
    assert "-DK1_W2_REG=0" in jobs["shared_w2"]
    built = _host_sources(jobs, tmp_path)
    with monkeypatch.context() as m:
        m.setattr(rk, "REGISTER_WEIGHTS_MAX", 8)
        assert built["shared_w2"].shared_bytes == rk.launch_geometry(
            N_T, 5, 42, 38).shared_bytes
    runs_ = [_host_run(e, params, goals, obs0, noise) for e in built.values()]
    for k in ("observations", "actions", "rewards"):
        assert torch.equal(runs_[1][k], runs_[0][k]), k
    assert torch.equal(runs_[1]["agent_infos"]["mean"],
                       runs_[0]["agent_infos"]["mean"])
    _hold_host_against_plain(runs_[0], plain)
    assert 0 < int((plain["rewards"] != 0).sum()) < plain["rewards"].numel()
