"""Training data pipeline (PyTorch port of ``tpuslo/models/data.py``):
a deterministic corpus into device-prefetched batches.

* byte-level tokenization on the host (ids 0-255 are bytes, 256 is BOS,
  the serving tokenizer's ids), packed into fixed ``(batch, seq_len)``
  windows;
* a seeded ``np.random.RandomState`` permutation over the windows per
  epoch, the JAX module's, so the same seed gives the same batches bit
  for bit in both packages;
* a prefetch thread that stages the next batches on the device while the
  current step runs.  On the card it copies pinned host tensors with
  ``non_blocking=True`` on a CUDA stream of its own and records an event
  after each copy; the consumer's stream waits on that event before the
  batch is used, so the copy overlaps the step without a host wait.

Batches arrive as int64 tensors (the index dtype of PyTorch's gathers);
the values are the JAX module's int32 ones.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tpuslo_torch.device import resolve_device

BOS = 256


def tokenize_corpus(texts: list[str]) -> np.ndarray:
    """Byte-tokenize and concatenate a corpus with BOS separators."""
    out: list[int] = []
    for text in texts:
        out.append(BOS)
        out.extend(text.encode("utf-8"))
    return np.asarray(out, dtype=np.int32)


def window_batches(
    tokens: np.ndarray,
    batch: int,
    seq_len: int,
    seed: int = 0,
    epochs: int = 1,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens, targets) pairs of shape (batch, seq_len): the corpus
    cut into non-overlapping ``seq_len + 1`` windows (inputs and
    next-token targets share a window, shifted by one), each epoch
    visiting every full window in a seeded permutation."""
    stride = seq_len + 1
    n_windows = len(tokens) // stride
    if n_windows < batch:
        raise ValueError(
            f"corpus has {n_windows} windows of {stride}; need >= {batch}"
        )
    windows = tokens[: n_windows * stride].reshape(n_windows, stride)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(n_windows)
        for start in range(0, n_windows - batch + 1, batch):
            sel = windows[order[start : start + batch]]
            yield sel[:, :-1].copy(), sel[:, 1:].copy()


def _stage(host: np.ndarray, device: torch.device, stream) -> torch.Tensor:
    """One host array as an int64 tensor on ``device``: on the card a
    pinned copy sent on ``stream`` without waiting."""
    t = torch.from_numpy(host).long()
    if device.type != "cuda":
        return t.to(device)
    with torch.cuda.stream(stream):
        return t.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(
    batches: Iterator[tuple[np.ndarray, np.ndarray]],
    device: str | torch.device = "cuda",
    depth: int = 2,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Stage ``depth`` batches ahead on ``device``.

    A daemon thread pulls host batches and copies them to the device (on
    the card: on its own stream, an event recorded after each pair; the
    consumer's current stream waits on it before the pair is yielded).
    The bounded queue is the backpressure.  A worker exception re-raises
    in the consumer (a failed copy must not look like the end of the
    stream), and closing the generator early (``.close()``, or ``break``
    and collection) ends the worker instead of leaking it.
    """
    dev = resolve_device(device)
    items: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                items.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for host_tokens, host_targets in batches:
                if stop.is_set():
                    return
                pair = (_stage(host_tokens, dev, stream), _stage(host_targets, dev, stream))
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                if not put(("item", (pair, ready))):
                    return
            put(("done", None))
        except BaseException as exc:  # noqa: BLE001 - re-raised by the consumer
            put(("error", exc))

    thread = threading.Thread(target=worker, daemon=True, name="prefetch_to_device")
    thread.start()
    try:
        while True:
            kind, payload = items.get()
            if kind == "done":
                return
            if kind == "error":
                raise payload
            pair, ready = payload
            if ready is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(ready)
                for t in pair:  # allocated on the copy stream, used on this one
                    t.record_stream(current)
            yield pair
    finally:
        stop.set()
        # Drain so a worker blocked on put() wakes and exits.
        while True:
            try:
                items.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)


def corpus_stream(
    texts: list[str],
    batch: int,
    seq_len: int,
    device: str | torch.device = "cuda",
    seed: int = 0,
    epochs: int = 1,
    skip: int = 0,
    rows: tuple[int, int] | None = None,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """tokenize, window, shuffle and prefetch, in one call.  ``skip``
    passes over already-consumed batches on the host, before any copy to
    the device, which is what a checkpoint resume wants.  ``rows=(index,
    count)``: a data rank's part of every global batch, the ``index``-th
    of ``count`` equal runs of rows (``batch_sharding``'s row-major rank
    order), cut on the host so that only those rows reach the device."""
    tokens = tokenize_corpus(texts)
    host = window_batches(tokens, batch, seq_len, seed=seed, epochs=epochs)
    if skip:
        host = itertools.islice(host, skip, None)
    if rows is not None:
        index, count = rows
        if batch % count:
            raise ValueError(f"batch={batch} does not split into {count} data ranks")
        n = batch // count
        host = ((t[index * n:(index + 1) * n], g[index * n:(index + 1) * n]) for t, g in host)
    return prefetch_to_device(host, device=device)
