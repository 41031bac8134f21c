"""Checkpoint and resume for the training loop (PyTorch port of
``tpuslo/models/checkpoint.py``).

The JAX module writes orbax checkpoints; orbax has no PyTorch side, so
this one writes PyTorch's own serialization (``torch.save``) and reads it
back with ``torch.load(weights_only=True)``, which loads tensors and
plain containers and runs no pickled code.  What it keeps of the JAX
module:

* :func:`save_checkpoint` / :func:`restore_checkpoint` for one tree,
  with the overwrite guard;
* :class:`TrainCheckpointer`: keep-N rotation by step, an asynchronous
  save (the copy to the host happens on the caller's thread, so the step
  that follows cannot change what is saved; the file is written on a
  worker thread, and :meth:`TrainCheckpointer.close` drains it), and
  :meth:`~TrainCheckpointer.restore` onto a given device;
* int8 ``{"q", "s"}`` leaves round-trip as they are.

A sharded run's checkpoint is written the same way, by rank 0, from the
whole tree gathered over the mesh (``train.gather_state``: the
parameters and the AdamW moments as whole leaves), and every rank
restores its own parts of it, so that a checkpoint does not depend on the
layout (the trainer).

Every write goes to a temporary file in the same directory that is then
renamed over the target, so a crash mid-write leaves the previous
checkpoint whole.
"""

from __future__ import annotations

import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

PyTree = Any

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _to_host(tree: PyTree) -> PyTree:
    """A copy of ``tree`` with every tensor detached and copied to the
    host (a synchronizing copy: the caller's later writes cannot reach
    it)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _atomic_save(obj: PyTree, path: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, tree: PyTree, overwrite: bool = False) -> None:
    """Blocking single-tree save (params, or a dict of params and an
    optimizer's state dict)."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    _atomic_save(_to_host(tree), path)


def restore_checkpoint(path: str, device: str | torch.device = "cpu") -> PyTree:
    """A tree saved by :func:`save_checkpoint`, its tensors on ``device``."""
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


class TrainCheckpointer:
    """Rotating keep-N checkpoints of a training loop: one file
    ``<directory>/<step>.pt`` per saved step.

    :meth:`save` copies the state to the host and returns; a worker
    thread writes the file and then deletes all but the newest
    ``max_to_keep`` steps.  A failed write raises from the next
    :meth:`save`, :meth:`restore` or :meth:`close`.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: list[tuple[int, Future]] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _steps_on_disk(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP_FILE.match(name)))

    def _write(self, step: int, tree: PyTree) -> None:
        _atomic_save(tree, self._path(step))
        for old in self._steps_on_disk()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _drain(self) -> None:
        pending, self._pending = self._pending, []
        for _, future in pending:
            future.result()

    def save(self, step: int, params: PyTree, opt_state=None) -> None:
        """Save ``params`` (and the optimizer's state dict, given the
        optimizer or the dict itself) as ``step``."""
        running = []
        for pending in self._pending:
            if pending[1].done():
                pending[1].result()  # raises a failed write
            else:
                running.append(pending)
        self._pending = running
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = (opt_state.state_dict()
                                 if isinstance(opt_state, torch.optim.Optimizer) else opt_state)
        self._pending.append((step, self._pool.submit(self._write, step, _to_host(tree))))

    def latest_step(self) -> int | None:
        steps = self._steps_on_disk() + [s for s, _ in self._pending]
        return max(steps) if steps else None

    def restore(self, step: int | None = None, device: str | torch.device = "cpu") -> dict:
        """``{"params", "opt_state"?}`` of ``step`` (default the latest),
        tensors on ``device``."""
        self._drain()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps in {self.directory}")
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def close(self) -> None:
        try:
            self._drain()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
