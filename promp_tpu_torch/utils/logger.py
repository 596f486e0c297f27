"""Key-value logger: stdout table, log file and CSV, plus snapshots.

The port's own copy of the parts of promp_tpu/utils/logger.py it uses:
``configure``, ``log``, ``logkv``, ``dumpkvs``,
``save_itr_params`` (the reference's default snapshot mode "last": the
newest iteration's params.pkl) and ``sync_snapshots``. A run is one
process, so files carry no rank suffix. Snapshots are pickled and written
durably (fsync, then an atomic rename) on the calling thread.
"""
from __future__ import annotations

import csv as _csv
import datetime
import os
import os.path as osp
import pickle
import sys
import tempfile

INFO = 20


def _scalar(v):
    return float(v) if hasattr(v, "dtype") else v


class HumanOutputFormat:
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


class CSVOutputFormat:
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


def make_output_format(fmt, ev_dir):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, "log.txt"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, "progress.csv"))
    raise ValueError(f"Unknown format {fmt!r}")


def _write_durable(path, blob):
    fd, tmp = tempfile.mkstemp(dir=osp.dirname(path) or ".",
                               prefix=".snapshot-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if osp.exists(tmp):
            os.unlink(tmp)
        raise


class Logger:
    CURRENT = None

    def __init__(self, dir, output_formats):
        self.name2val = {}
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def dumpkvs(self):
        for fmt in self.output_formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, HumanOutputFormat):
                    fmt.writeseq(map(str, args))

    def save_itr_params(self, itr, params):
        """Pickle ``params`` (iteration ``itr``'s snapshot) over
        params.pkl."""
        if not self.dir:
            return
        _write_durable(osp.join(self.dir, "params.pkl"),
                       pickle.dumps(params, protocol=pickle.HIGHEST_PROTOCOL))

    def sync_snapshots(self):
        """Snapshots are durable when ``save_itr_params`` returns."""
        return True

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


def configure(dir=None, format_strs=None):
    if dir is None:
        dir = osp.join(tempfile.gettempdir(), datetime.datetime.now().strftime(
            "promp-torch-%Y-%m-%d-%H-%M-%S-%f"))
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = ["stdout", "log", "csv"]
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, [make_output_format(f, dir)
                                  for f in format_strs])
    log(f"Logging to {dir}")
    return dir


def _get():
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(None, [HumanOutputFormat(sys.stdout)])
    return Logger.CURRENT


def logkv(key, val):
    _get().logkv(key, val)


def dumpkvs():
    _get().dumpkvs()


def log(*args, level=INFO):
    _get().log(*args, level=level)


def save_itr_params(itr, params):
    _get().save_itr_params(itr, params)


def sync_snapshots():
    return _get().sync_snapshots()
