"""The port's native host writers (promp_tpu_torch/utils/native.py over
csrc/logsink.cpp and csrc/ckptwriter.cpp, built with g++), mirroring the
JAX package's tests of promp_tpu/utils/native.py (tests/test_trainer.py
TestNativeSink, TestNativeCheckpointWriter): the build, the sink round
trip, the durable round trip, and a failed write reported. Exact: bytes
and counts."""
import os
import pickle

import pytest

pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu_torch.ops import nvcc_build  # noqa: E402
from promp_tpu_torch.utils import native  # noqa: E402


def test_gxx_build_is_hash_named_in_build_dir():
    path = nvcc_build.build_host("ckptwriter", "ckptwriter.cpp")
    assert os.path.dirname(path) == nvcc_build.BUILD_DIR
    assert os.path.basename(path).startswith("libckptwriter_")
    want = nvcc_build.library_path(
        "ckptwriter", nvcc_build.read_source("ckptwriter.cpp"),
        nvcc_build.HOST_FLAGS)
    assert path == want and os.path.exists(path)
    # never the JAX package's runtime/ libraries
    assert "runtime" not in path.split(os.sep)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken"):
        nvcc_build.build_all([("broken", "int f( {", nvcc_build.HOST_FLAGS)],
                             compiler=nvcc_build.find_gxx, suffix=".cpp")
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]


def test_async_sink_roundtrip(tmp_path):
    path = str(tmp_path / "out.txt")
    sink = native.AsyncFileSink(path)
    assert sink.native
    for i in range(500):
        sink.write(f"line{i}\n")
    sink.flush()
    assert sink.dropped_rows() == 0
    sink.close()
    lines = open(path).read().splitlines()
    assert len(lines) == 500
    assert lines[499] == "line499"


def test_async_durable_roundtrip(tmp_path):
    w = native.AsyncCheckpointWriter()
    path = str(tmp_path / "params.pkl")
    # several writes to one path: FIFO order, the last wins
    seqs = [w.submit(path, pickle.dumps({"itr": i})) for i in range(5)]
    assert seqs == sorted(seqs) and w.submitted == 5
    assert w.wait(seqs[-1])
    assert pickle.load(open(path, "rb")) == {"itr": 4}
    assert w.errors() == 0 and w.pending() == 0
    w.close()
    assert [p for p in os.listdir(tmp_path) if ".tmp" in p] == []


def test_failed_write_reported(tmp_path):
    w = native.AsyncCheckpointWriter()
    seq = w.submit(str(tmp_path / "no_such_dir" / "x.pkl"), b"data")
    assert w.wait_status(seq, 5.0) == -1
    assert not w.wait(seq)
    assert w.errors() == 1
    w.close()
    # the count outlives the writer's thread
    assert w.errors() == 1
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(str(tmp_path / "y.pkl"), b"data")
