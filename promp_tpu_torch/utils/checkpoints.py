"""Checkpoints and resume (port of promp_tpu/utils/checkpoints.py).

A snapshot is the Trainer's ``get_itr_snapshot``: a plain dict with numpy
leaves (train_state, optimizer state, hyperparameters, the generator's
state, the iteration and the static config), which is what resuming
bit-identically needs. Writes are atomic (temp file and rename), so a
preempted run never leaves a torn snapshot; ``latest_snapshot`` reads the
files of every snapshot mode of the logger.
"""
from __future__ import annotations

import os
import pickle
import tempfile


def save_snapshot(path, snapshot):
    """Atomic pickle write."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(snapshot, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_snapshot(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def latest_snapshot(run_dir):
    """The newest snapshot of a run directory: params.pkl where there is
    one, else the highest-numbered itr_<n>.pkl, else None."""
    last = os.path.join(run_dir, "params.pkl")
    if os.path.exists(last):
        return last
    best_itr, best = -1, None
    for name in os.listdir(run_dir):
        if name.startswith("itr_") and name.endswith(".pkl"):
            try:
                itr = int(name[4:-4])
            except ValueError:
                continue
            if itr > best_itr:
                best_itr, best = itr, os.path.join(run_dir, name)
    return best


def resume_trainer(trainer, run_dir):
    """Restore ``trainer`` from the newest snapshot in ``run_dir``; returns
    the iteration it will start at (0 when there is no snapshot)."""
    path = latest_snapshot(run_dir)
    if path is None:
        return 0
    trainer.restore(load_snapshot(path))
    return trainer.start_itr
