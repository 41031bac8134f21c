"""The port's checkpoints (``tpuslo_torch.models.checkpoint``): the
round trips of ``tests/test_checkpoint.py`` (dense, int8, an optimizer's
state), the overwrite guard, keep-N rotation, the asynchronous save's
host copy and error, and atomic writes.  Every round trip is bitwise."""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import checkpoint as ckpt_mod  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import train as ttrain  # noqa: E402
from tpuslo_torch.models.checkpoint import (  # noqa: E402
    TrainCheckpointer,
    restore_checkpoint,
    save_checkpoint,
)

CFG = tl.llama_tiny(max_seq_len=32)


def _trees_equal(a, b):
    la, lb = ttrain.param_leaves(a), ttrain.param_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        assert torch.equal(x.detach().cpu(), y.detach().cpu()), path


def test_save_restore_roundtrip(tmp_path):
    params = tl.init_params(0, CFG, "cpu")
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, params)
    _trees_equal(params, restore_checkpoint(path))


def test_overwrite_guard(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"x": torch.arange(4)})
    with pytest.raises(FileExistsError):
        save_checkpoint(path, {"x": torch.arange(4)})
    save_checkpoint(path, {"x": torch.arange(8)}, overwrite=True)
    assert restore_checkpoint(path)["x"].shape == (8,)


def test_quantized_tree_roundtrip(tmp_path):
    """int8 {"q", "s"} leaves as the JAX package quantizes them."""
    qj = jl.quantize_params(jl.init_params(jax.random.PRNGKey(0), jl.llama_tiny(max_seq_len=32)))
    qparams = bridge.params_from_numpy(jax.tree.map(np.asarray, qj), CFG, "cpu")
    path = str(tmp_path / "q.pt")
    save_checkpoint(path, qparams)
    restored = restore_checkpoint(path)
    assert restored["layers"]["w1"]["q"].dtype == torch.int8
    _trees_equal(qparams, restored)


def _stepped_optimizer():
    params = ttrain.trainable(tl.init_params(1, CFG, "cpu"))
    opt = ttrain.make_optimizer().init(params)
    tok = torch.randint(0, CFG.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    ttrain.train_step(params, opt, tok, tok, CFG)
    return params, opt


def test_train_checkpointer_rotation_and_resume(tmp_path):
    params, opt = _stepped_optimizer()
    with TrainCheckpointer(str(tmp_path / "mgr"), max_to_keep=2) as ckpt:
        for step in (1, 2, 3):
            scaled = {k: v for k, v in params.items()}
            scaled["output"] = params["output"].detach() * step
            ckpt.save(step, scaled, opt_state=opt)
        assert ckpt.latest_step() == 3
        restored = ckpt.restore()
        assert torch.equal(restored["params"]["output"], params["output"].detach() * 3)
        # keep-N rotation: step 1 evicted
        assert sorted(os.listdir(ckpt.directory)) == ["2.pt", "3.pt"]
    # the optimizer's state dict loads into a fresh optimizer, bitwise
    fresh_params = ttrain.trainable(restored["params"])
    fresh = ttrain.make_optimizer().init(fresh_params)
    fresh.load_state_dict(restored["opt_state"])
    for (_, p), (_, q) in zip(ttrain.param_leaves(params), ttrain.param_leaves(fresh_params)):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], fresh.state[q][key]), key


def test_save_copies_to_the_host_before_returning(tmp_path):
    """A later in-place write (the next step) cannot reach a saved state."""
    x = torch.zeros(4)
    with TrainCheckpointer(str(tmp_path / "mgr")) as ckpt:
        ckpt.save(1, {"x": x})
        x.add_(1.0)
        assert torch.equal(ckpt.restore(1)["params"]["x"], torch.zeros(4))


def test_a_failed_write_raises_and_keeps_the_last_checkpoint(tmp_path, monkeypatch):
    directory = str(tmp_path / "mgr")
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(1, {"x": torch.ones(2)})
    real_save = torch.save

    def torn(obj, path):  # writes half a file, then dies
        with open(path, "wb") as fh:
            fh.write(b"torn")
        raise OSError("disk went away")

    monkeypatch.setattr(ckpt_mod.torch, "save", torn)
    ckpt = TrainCheckpointer(directory)
    ckpt.save(2, {"x": torch.full((2,), 2.0)})
    with pytest.raises(OSError, match="disk went away"):
        ckpt.close()
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    assert sorted(os.listdir(directory)) == ["1.pt"]  # no torn or temporary file
    with TrainCheckpointer(directory) as again:
        assert again.latest_step() == 1
        assert torch.equal(again.restore()["params"]["x"], torch.ones(2))


def test_restore_without_steps_raises(tmp_path):
    with TrainCheckpointer(str(tmp_path / "empty")) as ckpt:
        assert ckpt.latest_step() is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore()
