"""Builds the port's CUDA kernels with nvcc, and its host libraries (the
async log and checkpoint writers) with g++, and loads them with ctypes.

Each library is compiled from its source text into a shared library with
a plain C entry point, under ``promp_tpu_torch/_build/`` (git-ignored), at
its first use and never at import. The library's name hashes the source
and the flags, so a changed source or flag builds anew and an unchanged
one is reused. ``build_all`` starts one compiler per source at once and
waits for all of them; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
# sm_90a: Hopper; a plain-C interface, so no PyTorch headers to compile
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall")

_loaded = {}


def find_nvcc():
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH; raises with
    the places searched when there is none."""
    searched = []
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            path = os.path.join(root, "bin", "nvcc")
            searched.append(path)
            if os.access(path, os.X_OK):
                return path
    on_path = shutil.which("nvcc")
    searched.append("PATH")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found; searched: " + ", ".join(searched))


def find_gxx():
    """g++ on PATH; raises when there is none."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH")
    return path


def read_source(filename):
    with open(os.path.join(CSRC_DIR, filename)) as f:
        return f.read()


def library_path(name, source, flags):
    digest = hashlib.sha256(
        (source + "\0" + " ".join(flags)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


class BuildResult:
    """One library: its path, nvcc's wall time in seconds (0 when it was
    already built) and nvcc's output (the ptxas report, where asked for)."""

    def __init__(self, path, seconds, log):
        self.path, self.seconds, self.log = path, seconds, log


def build_all(jobs, compiler=find_nvcc, suffix=".cu"):
    """Compile each ``(name, source, flags)`` in ``jobs`` unless its library
    exists, one ``compiler()`` process per job (nvcc unless given), all
    started together; returns one ``BuildResult`` per job, in order. Raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running, results, failures = [], [], []
    try:
        for name, source, flags in jobs:
            lib = library_path(name, source, flags)
            if os.path.exists(lib):
                running.append((lib, None, None, name, 0.0))
                continue
            # the source beside its library, renamed into place whole, so
            # that another process building the same library at once never
            # reads it half written
            src = lib[:-3] + suffix
            fd, tmp_src = tempfile.mkstemp(dir=BUILD_DIR, suffix=suffix)
            with os.fdopen(fd, "w") as f:
                f.write(source)
            os.replace(tmp_src, src)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            running.append((lib, None, tmp, name, 0.0))
            proc = subprocess.Popen(
                [compiler(), *flags, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            running[-1] = (lib, proc, tmp, name, time.time())
        for lib, proc, tmp, name, t0 in running:
            if tmp is None:
                results.append(BuildResult(lib, 0.0, ""))
                continue
            log, _ = proc.communicate()
            seconds = time.time() - t0
            if proc.returncode != 0:
                failures.append(f"{os.path.basename(proc.args[0])} failed "
                                f"on {name} ({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, lib)
            results.append(BuildResult(lib, seconds, log))
    finally:
        for _, proc, tmp, _, _ in running:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def build(name, source, flags):
    """``build_all`` of one job; returns the library's path."""
    return build_all([(name, source, flags)])[0].path


def build_host(name, filename):
    """The library of the C++ host source ``csrc/<filename>``, built with
    g++ unless it exists; returns its path."""
    return build_all([(name, read_source(filename), HOST_FLAGS)],
                     compiler=find_gxx, suffix=".cpp")[0].path


def load(path):
    """The library at ``path`` through ctypes, loaded once a process."""
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(path)
    return _loaded[path]
