"""The batch-invariance tooling of the port, on the CPU: the op trace of
the cached passes (``llama.trace_ops``), the probe that names the first
op whose bits depend on the batch (``probes exactness --first-diff``),
the launch counters a CUDA graph credits at replay
(``ops.launch_counts``) and the RMSNorm wrapper's plain version.

The card's side of it (the kernels, rows alone against rows inside
batches of 2 to 200, a pass's logits at B 1, 2 and 8) is in
``tests/test_torch_card.py``.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo_torch.benchmark import probes  # noqa: E402
from tpuslo_torch.models import llama, serve, speculative  # noqa: E402
from tpuslo_torch.ops import launch_counts  # noqa: E402
from tpuslo_torch.ops import rms_norm as rn  # noqa: E402

LAYER_OPS = ["attn_norm", "q", "k", "v", "rope_q", "rope_k", "attention", "wo", "wo_residual",
             "mlp_norm", "w1", "w3", "silu_mul", "w2", "w2_residual"]


def _tiny(dtype=torch.float32):
    cfg = dataclasses.replace(llama.llama_tiny(max_seq_len=64), dtype=dtype)
    return cfg, llama.init_params(0, cfg, "cpu")


@pytest.mark.parametrize("pass_", ["verify", "decode"])
def test_trace_ops_records_every_op_of_a_pass_in_order(pass_):
    cfg, params = _tiny()
    cache = llama.init_kv_cache(cfg, 2, device="cpu")
    cache["length"] = torch.tensor([3, 9])
    seen = []
    with llama.trace_ops(lambda op, layer, t: seen.append((op, layer, tuple(t.shape)))):
        if pass_ == "verify":
            logits, _ = llama.verify_chunk(params, torch.ones((2, 4), dtype=torch.long), cache,
                                           cfg)
        else:
            logits, _ = llama.decode_step(params, torch.ones((2,), dtype=torch.long), cache, cfg)
    want = [(op, i) for i in range(cfg.n_layers) for op in LAYER_OPS]
    assert [(op, layer) for op, layer, _ in seen] == want + [("final_norm", None),
                                                            ("logits", None)]
    assert all(shape[0] == 2 for _, _, shape in seen)  # the batch leads every output
    assert seen[-1][2] == tuple(logits.shape)
    seen.clear()
    llama.verify_chunk(params, torch.ones((2, 4), dtype=torch.long), cache, cfg)
    assert seen == []  # nothing is recorded outside the block


def test_trace_ops_leaves_the_pass_unchanged():
    cfg, params = _tiny()
    cache = llama.init_kv_cache(cfg, 2, device="cpu")
    cache["length"] = torch.tensor([5, 1])
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]])
    plain, _ = llama.verify_chunk(params, toks, {**cache, "k": cache["k"].clone(),
                                                 "v": cache["v"].clone()}, cfg)
    with llama.trace_ops(lambda *a: None):
        traced, _ = llama.verify_chunk(params, toks, cache, cfg)
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("prompt_chunk", [False, True])
def test_a_prompt_chunk_takes_a_prefills_products(monkeypatch, prompt_chunk):
    """A dispatch's verify pass runs every weight product through
    ``_matmul`` (the card's fixed-row pieces); a prompt's chunk (a suffix
    prefill) runs them through ``_seq_matmul``, as a prefill does, and
    both give the same logits on the CPU."""
    cfg, params = _tiny()
    calls = {"_matmul": 0, "_seq_matmul": 0}
    for name in calls:
        real = getattr(llama, name)

        def spy(x, w, _real=real, _name=name):
            calls[_name] += 1
            return _real(x, w)

        monkeypatch.setattr(llama, name, spy)
    cache = llama.init_kv_cache(cfg, 2, device="cpu")
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]])
    logits, _ = llama.verify_chunk(params, toks, {**cache, "length": 4}, cfg,
                                   prompt_chunk=prompt_chunk)
    products = 7 * cfg.n_layers + 1  # wq wk wv wo w1 w3 w2 per layer, the head
    taken = "_seq_matmul" if prompt_chunk else "_matmul"
    assert calls == {**{n: 0 for n in calls}, taken: products}
    plain, _ = llama.verify_chunk(params, toks, {**llama.init_kv_cache(cfg, 2, device="cpu"),
                                                 "length": 4}, cfg)
    assert torch.equal(logits, plain)


def test_a_suffix_prefill_is_a_prompt_chunk(monkeypatch):
    cfg, params = _tiny()
    seen = []
    real = llama.verify_chunk

    def spy(*args, **kwargs):
        seen.append(kwargs.get("prompt_chunk", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(serve, "verify_chunk", spy)
    kv = llama.init_kv_cache(cfg, 1, device="cpu")
    serve.suffix_prefill(params, torch.tensor([[5, 6, 7, 0]]), kv, 3, 3, cfg)
    assert seen == [True]


def test_first_diff_rows_name_every_pass_and_batch():
    """The probe at a tiny width on the CPU: one row per (pass, batch),
    each naming the first differing op or none, and a lone row equals
    itself (a batch of one is the lone pass)."""
    cfg = dataclasses.replace(llama.llama_tiny(max_seq_len=96), dtype=torch.bfloat16)
    t = serve.ServeEngine(cfg, rng_seed=0, device="cpu")
    d = serve.ServeEngine(cfg, rng_seed=0, device="cpu")
    spec = speculative.SpeculativeEngine(t, d, k=3)
    texts = probes.prompts_of(3)
    want = spec.generate(texts[0], max_new_tokens=12, stop_at_eos=False)
    rows = probes.first_diff_rows(spec, texts[0], want, None, texts[1:], batches=(1, 2, 8))
    assert [(r["pass"], r["batch"]) for r in rows] == [
        (p, n) for n in (1, 2, 8) for p in ("verify", "draft")]
    assert all(r["at"] == len(want) - 1 and r["parted_at"] is None for r in rows)
    for r in rows:
        assert (r["first_op"] is None) == (r["layer"] is None) == (r["max_abs_diff"] == 0.0)
        assert r["first_op"] in [None, "final_norm", "logits"] + LAYER_OPS
    assert all(r["first_op"] is None for r in rows if r["batch"] == 1)


def test_exactness_rows_hold_the_front_door_to_the_single_stream():
    cfg = dataclasses.replace(llama.llama_tiny(max_seq_len=96), dtype=torch.float32)
    t = serve.ServeEngine(cfg, rng_seed=0, device="cpu")
    d = serve.ServeEngine(cfg, rng_seed=0, device="cpu")
    engines = (t, d, speculative.SpeculativeEngine(t, d, k=3))
    rows = probes.exactness("float32", 2, 10, "cpu", engines=engines)
    rows += probes.exactness_batched("float32", 3, 10, "cpu", engines=engines)
    assert [r["slots"] for r in rows] == [2, 2, 3, 3, 3]
    assert all(r["tokens"] == 10 and r["parted_at"] is None for r in rows)


class _Owner:
    pass


def test_launch_counts_take_back_and_credit(monkeypatch):
    monkeypatch.setattr(launch_counts, "_COUNTERS", [])
    a, b = _Owner(), _Owner()
    a.launches, a.other, b.launches = 0, 0, 5
    launch_counts.register(a, "launches", "other")
    launch_counts.register(b, "launches")
    launch_counts.register(a, "launches")  # once only
    before = launch_counts.snapshot()
    a.launches += 3
    b.launches += 1
    moved = launch_counts.since(before)
    assert sorted((id(o), attr, d) for o, attr, d in moved) == sorted(
        [(id(a), "launches", 3), (id(b), "launches", 1)])
    launch_counts.add(moved, -1)  # the capture recorded, launched nothing
    assert (a.launches, a.other, b.launches) == (0, 0, 5)
    for _ in range(2):  # two replays
        launch_counts.add(moved)
    assert (a.launches, a.other, b.launches) == (6, 0, 7)


def test_the_port_registers_its_counters():
    import importlib

    fa = importlib.import_module("tpuslo_torch.ops.flash_attention")
    pa = importlib.import_module("tpuslo_torch.ops.paged_attention")
    registered = {(id(o), attr) for o, attr in launch_counts._COUNTERS}
    for owner, attr in ((fa.flash_attention, "launches"), (fa.flash_attention, "f32_launches"),
                        (pa.paged_decode_attention, "launches"),
                        (pa.paged_decode_attention, "f32_launches"),
                        (rn.rms_norm, "launches"), (rn.add_rms_norm, "launches"),
                        (launch_counts, "cached_layers")):
        assert (id(owner), attr) in registered


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_plain_version_is_the_models(dtype):
    """On the CPU the wrapper is the plain version, which equals the JAX
    module's rms_norm, and launches nothing."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 64)).astype(np.float32) * 3
    w = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    before = rn.rms_norm.launches
    got = rn.rms_norm(xt, wt, 1e-5)
    assert rn.rms_norm.launches == before
    assert torch.equal(got, rn.rms_norm_reference(xt, wt, 1e-5))
    assert torch.equal(llama.rms_norm(xt, wt, 1e-5), got)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jl.rms_norm(jnp.asarray(xt.float().numpy()).astype(jdt),
                       jnp.asarray(wt.float().numpy()).astype(jdt), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-6 if dtype == torch.float32 else 2**-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_plain_version_is_the_models(dtype):
    """On the CPU the fused wrapper is the eager add and the plain norm:
    the sum equals the JAX module's ``h + d`` bit for bit, the norm its
    rms_norm of that sum, and nothing launches."""
    rng = np.random.default_rng(4)
    h, d = (rng.standard_normal((2, 3, 256)).astype(np.float32) * 3 for _ in range(2))
    w = 1 + 0.1 * rng.standard_normal(256).astype(np.float32)
    ht, dt, wt = (torch.from_numpy(a).to(dtype) for a in (h, d, w))
    before = rn.add_rms_norm.launches
    got_h, got_y = rn.add_rms_norm(ht, dt, wt, 1e-5)
    assert rn.add_rms_norm.launches == before
    assert torch.equal(got_h, ht + dt)
    assert torch.equal(got_y, rn.rms_norm_reference(ht + dt, wt, 1e-5))
    model_h, model_y = llama.add_rms_norm(ht, dt, wt, 1e-5)
    assert torch.equal(model_h, got_h) and torch.equal(model_y, got_y)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jh = jnp.asarray(ht.float().numpy()).astype(jdt) + jnp.asarray(dt.float().numpy()).astype(jdt)
    np.testing.assert_array_equal(got_h.float().numpy(), np.asarray(jh, np.float32))
    want = jl.rms_norm(jh, jnp.asarray(wt.float().numpy()).astype(jdt), 1e-5)
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-6 if dtype == torch.float32 else 2**-6, rtol=0)
