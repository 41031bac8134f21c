"""The port's training data pipeline against ``tpuslo.models.data``:
the fast tests of ``tests/test_data.py`` on the port, and the batches
of both packages equal, value for value, for three seeds and a skip."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuslo.models import data as jdata  # noqa: E402
from tpuslo_torch.models import data as tdata  # noqa: E402

CORPUS = [f"document {i}: the quick brown fox jumps over the lazy dog" for i in range(40)]


def test_tokenize_bos_separators():
    toks = tdata.tokenize_corpus(["ab", "c"])
    assert toks.tolist() == [256, 97, 98, 256, 99]
    np.testing.assert_array_equal(toks, jdata.tokenize_corpus(["ab", "c"]))


def test_window_batches_shapes_and_shift():
    toks = tdata.tokenize_corpus(CORPUS)
    tokens, targets = next(tdata.window_batches(toks, batch=4, seq_len=16))
    assert tokens.shape == targets.shape == (4, 16)
    np.testing.assert_array_equal(tokens[:, 1:], targets[:, :-1])


def test_deterministic_replay():
    toks = tdata.tokenize_corpus(CORPUS)
    a = [t.sum() for t, _ in tdata.window_batches(toks, 2, 16, seed=7)]
    b = [t.sum() for t, _ in tdata.window_batches(toks, 2, 16, seed=7)]
    c = [t.sum() for t, _ in tdata.window_batches(toks, 2, 16, seed=8)]
    assert a == b
    assert a != c


def test_small_corpus_rejected():
    with pytest.raises(ValueError, match="windows"):
        next(tdata.window_batches(tdata.tokenize_corpus(["x"]), batch=4, seq_len=128))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("skip", [0, 5])
def test_corpus_stream_equals_jax_batches(seed, skip):
    jax_batches = list(jdata.window_batches(jdata.tokenize_corpus(CORPUS), 4, 24, seed=seed,
                                            epochs=2))[skip:]
    stream = tdata.corpus_stream(CORPUS, batch=4, seq_len=24, device="cpu", seed=seed,
                                 epochs=2, skip=skip)
    got = list(stream)
    assert len(got) == len(jax_batches)
    for (tok, tgt), (jtok, jtgt) in zip(got, jax_batches):
        assert tok.dtype == torch.int64 and tok.device.type == "cpu"
        np.testing.assert_array_equal(tok.numpy(), jtok)
        np.testing.assert_array_equal(tgt.numpy(), jtgt)


def test_prefetch_propagates_worker_errors():
    def bad_batches():
        yield (np.zeros((2, 4), np.int32), np.zeros((2, 4), np.int32))
        raise RuntimeError("host pipeline exploded")

    stream = tdata.prefetch_to_device(bad_batches(), device="cpu")
    next(stream)
    with pytest.raises(RuntimeError, match="exploded"):
        next(stream)


def test_prefetch_close_stops_worker():
    before = threading.active_count()
    toks = tdata.tokenize_corpus(CORPUS)
    stream = tdata.prefetch_to_device(tdata.window_batches(toks, 2, 16, epochs=100),
                                      device="cpu")
    next(stream)
    stream.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tdata.prefetch_to_device(iter([]), device="cuda"))
