"""The port's logger (promp_tpu_torch/utils/logger.py) against the JAX
package's (promp_tpu/utils/logger.py): the same calls over iterations
0..12 under each snapshot mode leave the same snapshot files with the same
contents, equal csv and json rows, and TensorBoard event files whose
parsed records are equal (the wall clock pinned on both sides, so the raw
bytes are equal too); logkv_mean and profile. Exact comparisons."""
import json
import os
import pickle
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu.utils import logger as jlogger  # noqa: E402
from promp_tpu_torch.utils import logger as tlogger  # noqa: E402

MODES = ("all", "last", "gap", "last_gap", "none")
N_ITR, GAP = 13, 5
FORMATS = ["csv", "json", "tensorboard"]
WALL = 1_700_000_000.25


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    yield
    for mod in (jlogger, tlogger):
        if mod.Logger.CURRENT is not None:
            mod.Logger.CURRENT.close()
        mod.Logger.CURRENT = None


def _drive(mod, dir, mode, tensors):
    """The same logger calls on either package; ``tensors`` logs the port's
    values as torch tensors, which it writes as floats."""
    mod.configure(dir=dir, format_strs=FORMATS, snapshot_mode=mode,
                  snapshot_gap=GAP)
    val = (lambda x: torch.tensor(x)) if tensors else np.float32
    for itr in range(N_ITR):
        mod.logkv("Itr", itr)
        mod.logkv("Loss", val(0.25 * itr - 1.0))
        if itr >= 3:   # a key that appears later pads the csv's rows
            mod.logkv("Late", val(itr * 1e-3))
        mod.logkvs({"Name": "run", "Count": itr * 7})
        for x in (1.0, 2.0, 4.5):
            mod.logkv_mean("Mean", x + itr)
        mod.save_itr_params(itr, {"itr": itr, "w": np.arange(3) * itr})
        mod.dumpkvs()
    assert mod.sync_snapshots(60.0)
    mod.Logger.CURRENT.close()
    mod.Logger.CURRENT = None


def _tree(dir):
    return sorted(os.path.relpath(os.path.join(root, f), dir)
                  for root, _, files in os.walk(dir) for f in files)


def _varint(buf, i):
    shift = value = 0
    while True:
        b = buf[i]
        value |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return value, i
        shift += 7


def _fields(buf):
    """A protobuf message's (field, wire type, value) triples."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = struct.unpack("<d", buf[i:i + 8])[0], i + 8
        elif wire == 5:
            value, i = struct.unpack("<f", buf[i:i + 4])[0], i + 4
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = bytes(buf[i:i + n]), i + n
        else:
            raise ValueError(f"wire type {wire}")
        out.append((field, wire, value))
    return out


def parse_events(path):
    """The records of an event file as dicts: wall_time, step,
    file_version, and {tag: simple_value}; checks both masked CRCs of
    every record."""
    data, i, events = open(path, "rb").read(), 0, []
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == \
            tlogger._masked_crc(header)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            tlogger._masked_crc(payload)
        i += 16 + n
        event = {}
        for field, _, value in _fields(payload):
            if field == 1:
                event["wall_time"] = value
            elif field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value
            elif field == 5:
                event["values"] = {}
                for _, _, v in _fields(value):
                    tag = simple = None
                    for f, _, x in _fields(v):
                        if f == 1:
                            tag = x.decode()
                        elif f == 2:
                            simple = x
                    event["values"][tag] = simple
        events.append(event)
    return events


def test_crc32c_check_value():
    # the standard CRC-32C check value
    assert tlogger._crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_modes_and_formats_match_jax(tmp_path, pinned_clock, mode):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _drive(jlogger, jdir, mode, tensors=False)
    _drive(tlogger, tdir, mode, tensors=True)
    files = _tree(jdir)
    assert files == _tree(tdir)
    snaps = [f for f in files if f.endswith(".pkl")]
    want = {"all": [f"itr_{i}.pkl" for i in range(N_ITR)],
            "gap": [f"itr_{i}.pkl" for i in range(0, N_ITR, GAP)],
            "last": ["params.pkl"], "last_gap": ["params.pkl"],
            "none": []}[mode]
    assert snaps == sorted(want)
    for f in snaps:
        a = pickle.load(open(os.path.join(jdir, f), "rb"))
        b = pickle.load(open(os.path.join(tdir, f), "rb"))
        assert a["itr"] == b["itr"]
        np.testing.assert_array_equal(a["w"], b["w"])
    if mode == "last":
        assert pickle.load(open(os.path.join(tdir, "params.pkl"),
                                "rb"))["itr"] == N_ITR - 1
    if mode == "last_gap":
        assert pickle.load(open(os.path.join(tdir, "params.pkl"),
                                "rb"))["itr"] == 10
    for name in ("progress.csv", "progress.json"):
        assert open(os.path.join(tdir, name)).read() == \
            open(os.path.join(jdir, name)).read(), name
    rows = [json.loads(line) for line in
            open(os.path.join(tdir, "progress.json"))]
    assert len(rows) == N_ITR and rows[4]["Mean"] == pytest.approx(6.5)
    (tb,) = [f for f in files if f.startswith("tb" + os.sep)]
    jevents = parse_events(os.path.join(jdir, tb))
    tevents = parse_events(os.path.join(tdir, tb))
    assert tevents == jevents
    assert len(tevents) == N_ITR + 1
    assert tevents[0] == dict(wall_time=WALL, file_version=b"brain.Event:2")
    assert tevents[5]["step"] == 4
    assert tevents[5]["values"]["Loss"] == 0.0
    assert "Name" not in tevents[5]["values"]
    assert open(os.path.join(tdir, tb), "rb").read() == \
        open(os.path.join(jdir, tb), "rb").read()


def test_snapshots_go_through_the_native_writer(tmp_path):
    tlogger.configure(dir=str(tmp_path), format_strs=[], snapshot_mode="all")
    for itr in range(3):
        tlogger.save_itr_params(itr, {"itr": itr})
    assert tlogger.sync_snapshots(60.0)
    report = tlogger.Logger.CURRENT.snapshot_report
    assert report == dict(native=True, submitted=3, errors=0)
    assert [p.name for p in tmp_path.iterdir() if ".tmp" in p.name] == []


def test_invalid_snapshot_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="snapshot mode"):
        tlogger.configure(dir=str(tmp_path), format_strs=[],
                          snapshot_mode="sometimes")


def test_logkv_mean_matches_jax(tmp_path):
    for mod in (jlogger, tlogger):
        mod.configure(dir=str(tmp_path / mod.__name__), format_strs=["json"])
        for x in (0.1, 0.7, 2.0, -3.5):
            mod.logkv_mean("m", x)
        mod.logkv_mean("n", None)
        mod.dumpkvs()
        mod.logkv_mean("m", 5.0)   # a dump starts a new mean
        mod.dumpkvs()
        mod.Logger.CURRENT.close()
        mod.Logger.CURRENT = None
    rows = {name: [json.loads(line) for line in open(
        tmp_path / name / "progress.json")]
        for name in (jlogger.__name__, tlogger.__name__)}
    assert rows[tlogger.__name__] == rows[jlogger.__name__]
    assert rows[tlogger.__name__][1] == {"m": 5.0}


def test_profile_accumulates_wait_time(tmp_path):
    tlogger.configure(dir=str(tmp_path), format_strs=["json"])

    @tlogger.profile("step")
    def step(x):
        time.sleep(0.01)
        return x + 1

    assert step(1) == 2 and step(2) == 3
    with tlogger.ProfileKV("io"):
        time.sleep(0.01)
    vals = dict(tlogger.Logger.CURRENT.name2val)
    assert sorted(vals) == ["wait_io", "wait_step"]
    assert vals["wait_step"] >= 0.02 and vals["wait_io"] >= 0.01
    assert step.__name__ == "step"
