"""Key-value logger: stdout table, log file, CSV, JSON and TensorBoard
event files, plus snapshots (port of promp_tpu/utils/logger.py).

``logkv`` / ``logkv_mean`` / ``logkvs`` / ``dumpkvs``; the formats
``stdout``, ``log``, ``csv``, ``json`` and ``tensorboard``;
``ProfileKV`` / ``profile``, which add wall time under ``wait_<name>``;
and ``save_itr_params`` under the snapshot modes ``all`` (itr_<n>.pkl each
iteration), ``last`` (params.pkl each iteration), ``gap`` (itr_<n>.pkl
every ``snapshot_gap``-th), ``last_gap`` (params.pkl every
``snapshot_gap``-th) and ``none``. Snapshots are pickled on the caller's
thread and handed to the g++-built ``AsyncCheckpointWriter``
(utils/native.py), which makes them durable off the training thread;
``sync_snapshots`` waits for them. A run is one process, so files carry no
rank suffix.
"""
from __future__ import annotations

import csv as _csv
import datetime
import functools
import json
import os
import os.path as osp
import pickle
import socket
import struct
import sys
import tempfile
import time
from collections import defaultdict

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50

SNAPSHOT_MODES = ("all", "last", "gap", "last_gap", "none", None)


def _scalar(v):
    return float(v) if hasattr(v, "dtype") else v


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError

    def close(self):
        pass


class SeqWriter:
    def writeseq(self, seq):
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    """Boxed key-value table on stdout or in a log file."""

    def __init__(self, file):
        self.own_file = isinstance(file, str)
        self.file = open(file, "wt") if self.own_file else file

    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in key2str.items():
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | "
                         f"{val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[:maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq):
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """progress.json: one JSON object a row."""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        self.file.write(json.dumps({k: _scalar(v) for k, v in kvs.items()})
                        + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """progress.csv; a new key rewrites the header and pads old rows."""

    def __init__(self, filename):
        self.file = open(filename, "w+t")
        self.keys = []

    def writekvs(self, kvs):
        extra_keys = [k for k in kvs if k not in self.keys]
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.truncate()
            _csv.writer(self.file).writerow(self.keys)
            for line in lines[1:]:
                self.file.write(line.rstrip("\n"))
                self.file.write("," * len(extra_keys) + "\n")
        _csv.writer(self.file).writerow(
            ["" if kvs.get(k) is None else _scalar(kvs[k]) for k in self.keys])
        self.file.flush()

    def close(self):
        self.file.close()


_CRC32C_TABLE = None


def _crc32c(data):
    """CRC-32C (Castagnoli), table-driven, for the record framing of
    TensorBoard event files."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _pb_varint(v):
    out = bytearray()
    while True:
        bits = v & 0x7F
        v >>= 7
        if v:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _pb_bytes(field_num, payload):
    return _pb_varint((field_num << 3) | 2) + _pb_varint(len(payload)) \
        + payload


class TensorBoardOutputFormat(KVWriter):
    """TensorBoard scalar event files with no TensorBoard or TF
    dependency: the Event and Summary protobuf messages and the record
    framing (length, masked CRC-32C) are encoded by hand. Each row is one
    Event at step ``Itr`` (else one more than the last) holding every value
    that converts to float."""

    def __init__(self, dirname):
        os.makedirs(dirname, exist_ok=True)
        path = osp.join(dirname, f"events.out.tfevents.{int(time.time())}."
                                 f"{socket.gethostname()}")
        self.file = open(path, "wb")
        self.step = 0
        # the header event: file_version (Event field 3)
        self._write_event(_pb_bytes(3, b"brain.Event:2"))

    def _write_event(self, payload):
        # wall_time: Event field 1, wire type 1 (double)
        payload = (_pb_varint(1 << 3 | 1) + struct.pack("<d", time.time())
                   + payload)
        header = struct.pack("<Q", len(payload))
        self.file.write(header)
        self.file.write(struct.pack("<I", _masked_crc(header)))
        self.file.write(payload)
        self.file.write(struct.pack("<I", _masked_crc(payload)))
        self.file.flush()

    def writekvs(self, kvs):
        step = int(kvs.get("Itr", self.step))
        values = b""
        for k, v in sorted(kvs.items()):
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            value_msg = (_pb_bytes(1, str(k).encode())      # tag
                         + _pb_varint(2 << 3 | 5)           # simple_value
                         + struct.pack("<f", fv))
            values += _pb_bytes(1, value_msg)
        event = (_pb_varint(2 << 3) + _pb_varint(step)      # step int64
                 + _pb_bytes(5, values))                    # summary
        self._write_event(event)
        self.step = step + 1

    def close(self):
        self.file.close()


def make_output_format(fmt, ev_dir):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, "log.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, "progress.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, "progress.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, "tb"))
    raise ValueError(f"Unknown format {fmt!r}")


def snapshot_path(dir, mode, gap, itr):
    """Where mode ``mode`` puts iteration ``itr``'s snapshot, or None when
    that iteration keeps none."""
    if mode not in SNAPSHOT_MODES:
        raise ValueError(f"Invalid snapshot mode {mode!r}")
    if mode in ("none", None) or (mode in ("gap", "last_gap")
                                  and itr % gap != 0):
        return None
    name = f"itr_{itr}.pkl" if mode in ("all", "gap") else "params.pkl"
    return osp.join(dir, name)


class Logger:
    CURRENT = None

    def __init__(self, dir, output_formats, snapshot_mode="last",
                 snapshot_gap=10):
        self.name2val = {}
        self.name2cnt = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats
        self.snapshot_mode = snapshot_mode
        self.snapshot_gap = snapshot_gap
        self._ckpt_writer = None   # built at the first snapshot
        self._last_ckpt_seq = 0
        self.snapshot_report = dict(native=None, submitted=0, errors=0)

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        """Running mean of the values logged under ``key`` since the last
        dump."""
        if val is None:
            self.name2val[key] = None
            return
        oldval, cnt = self.name2val.get(key, 0), self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        for fmt in self.output_formats:
            if isinstance(fmt, KVWriter):
                fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def save_itr_params(self, itr, params):
        """Pickle ``params`` (iteration ``itr``'s snapshot) and queue it on
        the async durable writer, where the snapshot mode keeps one."""
        if not self.dir:
            return
        path = snapshot_path(self.dir, self.snapshot_mode, self.snapshot_gap,
                             itr)
        if path is None:
            return
        blob = pickle.dumps(params, protocol=pickle.HIGHEST_PROTOCOL)
        if self._ckpt_writer is None:
            from promp_tpu_torch.utils.native import AsyncCheckpointWriter
            self._ckpt_writer = AsyncCheckpointWriter()
        self._last_ckpt_seq = self._ckpt_writer.submit(path, blob)
        self._update_report()

    def sync_snapshots(self, timeout_s=300.0):
        """Block until every queued snapshot is durable on disk; False if
        one failed or the wait timed out."""
        if self._ckpt_writer is None:
            return True
        ok = self._ckpt_writer.wait(self._last_ckpt_seq, timeout_s)
        self._update_report()
        return ok

    def _update_report(self):
        w = self._ckpt_writer
        self.snapshot_report = dict(native=w.native, submitted=w.submitted,
                                    errors=w.errors())

    def close(self):
        for fmt in self.output_formats:
            fmt.close()
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()   # completes every queued write
            self._update_report()
            self._ckpt_writer = None


def configure(dir=None, format_strs=None, snapshot_mode="last",
              snapshot_gap=10):
    """A new current logger writing ``format_strs`` (stdout, log and csv
    unless given) into ``dir`` (a fresh directory under the temp dir
    unless given); the previous one is closed, its snapshots completed."""
    if dir is None:
        dir = osp.join(tempfile.gettempdir(), datetime.datetime.now().strftime(
            "promp-torch-%Y-%m-%d-%H-%M-%S-%f"))
    if snapshot_mode not in SNAPSHOT_MODES:
        raise ValueError(f"Invalid snapshot mode {snapshot_mode!r}")
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = ["stdout", "log", "csv"]
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, [make_output_format(f, dir)
                                  for f in format_strs],
                            snapshot_mode, snapshot_gap)
    log(f"Logging to {dir}")
    return dir


def _get():
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(None, [HumanOutputFormat(sys.stdout)])
    return Logger.CURRENT


def logkv(key, val):
    _get().logkv(key, val)


def logkv_mean(key, val):
    _get().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    _get().dumpkvs()


def log(*args, level=INFO):
    _get().log(*args, level=level)


def save_itr_params(itr, params):
    _get().save_itr_params(itr, params)


def sync_snapshots(timeout_s=300.0):
    return _get().sync_snapshots(timeout_s)


def get_dir():
    return _get().dir


class ProfileKV:
    """``with ProfileKV(name)``: add the block's wall time to
    ``wait_<name>``."""

    def __init__(self, name):
        self.name = "wait_" + name

    def __enter__(self):
        self.start = time.time()

    def __exit__(self, *args):
        name2val = _get().name2val
        name2val[self.name] = (name2val.get(self.name, 0.0)
                               + time.time() - self.start)


def profile(name):
    """Decorator form of ``ProfileKV``."""
    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with ProfileKV(name):
                return func(*args, **kwargs)
        return wrapper
    return deco
