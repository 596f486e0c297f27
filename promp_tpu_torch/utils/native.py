"""ctypes bindings of the port's C++ host writers (port of
promp_tpu/utils/native.py):

  * ``AsyncFileSink`` (csrc/logsink.cpp): an append-only file whose writes
    a background thread puts on disk, so log rows never block the loop
    that feeds the card;
  * ``AsyncCheckpointWriter`` (csrc/ckptwriter.cpp): durable snapshots
    written on a background thread (temp file, fsync, rename over the
    target, fsync of the directory), so a snapshot never stalls training
    and a preempted run never leaves a torn file.

Each library is built with g++ at its first use into
``promp_tpu_torch/_build/`` (``ops/nvcc_build.py``, hash-named) and loaded
with ctypes. A failed build raises with the compiler's output: there is no
pure-Python fallback.
"""
from __future__ import annotations

import ctypes

from promp_tpu_torch.ops import nvcc_build

_libs = {}


def _library(name, filename, signatures):
    """The library ``name`` built from ``csrc/<filename>``, its functions
    typed by ``signatures`` ({function: (restype, argtypes)})."""
    if name not in _libs:
        lib = nvcc_build.load(nvcc_build.build_host(name, filename))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


_P, _S, _L = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long


def logsink_library():
    return _library("logsink", "logsink.cpp", {
        "logsink_open": (_P, [_S]),
        "logsink_write": (None, [_P, _S, ctypes.c_size_t]),
        "logsink_flush": (None, [_P]),
        "logsink_close": (None, [_P]),
        "logsink_queued": (ctypes.c_size_t, [_P]),
        "logsink_dropped": (ctypes.c_size_t, [_P]),
    })


def ckptwriter_library():
    return _library("ckptwriter", "ckptwriter.cpp", {
        "ckpt_open": (_P, []),
        "ckpt_submit": (_L, [_P, _S, _S, ctypes.c_size_t]),
        "ckpt_wait": (ctypes.c_int, [_P, _L, ctypes.c_int]),
        "ckpt_pending": (_L, [_P]),
        "ckpt_errors": (_L, [_P]),
        "ckpt_close": (None, [_P]),
    })


class AsyncCheckpointWriter:
    """Durable async snapshot writer on the C++ worker thread.

    ``submit(path, blob)`` queues serialized bytes and returns a sequence
    number at once; ``wait(seq)`` blocks until that write is durable (True)
    or failed or timed out (False). Writes to one path land in the order
    they were submitted.
    """

    def __init__(self):
        self._lib = ckptwriter_library()
        self._handle = self._lib.ckpt_open()
        self.native = True   # the g++-built library: there is no other path
        self.submitted = 0
        self._last_seq = 0
        self._errors = 0

    def submit(self, path, blob):
        """Queue ``blob`` for a durable write to ``path``; returns its
        sequence number (> 0)."""
        if not self._handle:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        seq = self._lib.ckpt_submit(self._handle, str(path).encode(), blob,
                                    len(blob))
        if seq <= 0:
            raise RuntimeError(f"ckpt_submit refused the write to {path}")
        self.submitted += 1
        self._last_seq = int(seq)
        return self._last_seq

    def wait_status(self, seq, timeout_s=60.0):
        """1 once write ``seq`` is durable, 0 on timeout, -1 if it
        failed."""
        return int(self._lib.ckpt_wait(self._handle, seq,
                                       int(timeout_s * 1000)))

    def wait(self, seq, timeout_s=60.0):
        """True once write ``seq`` is durable on disk."""
        return seq == 0 or self.wait_status(seq, timeout_s) == 1

    def pending(self):
        return int(self._lib.ckpt_pending(self._handle)) if self._handle else 0

    def errors(self):
        """Failed writes so far (all of them, once closed)."""
        if self._handle:
            self._errors = int(self._lib.ckpt_errors(self._handle))
        return self._errors

    def close(self):
        """Complete every submitted write, then stop the worker."""
        if getattr(self, "_handle", None):
            self._lib.ckpt_wait(self._handle, self._last_seq, 2 ** 31 - 1)
            self.errors()
            self._lib.ckpt_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class AsyncFileSink:
    """Append-only file written by the C++ writer thread."""

    def __init__(self, path):
        self.path = path
        self._lib = logsink_library()
        self._handle = self._lib.logsink_open(str(path).encode())
        if not self._handle:
            raise OSError(f"logsink_open could not open {path}")

    @property
    def native(self):
        return self._handle is not None

    def write(self, text):
        data = text.encode()
        self._lib.logsink_write(self._handle, data, len(data))

    def flush(self):
        self._lib.logsink_flush(self._handle)

    def dropped_rows(self):
        return int(self._lib.logsink_dropped(self._handle))

    def close(self):
        if self._handle:
            self._lib.logsink_close(self._handle)
            self._handle = None
