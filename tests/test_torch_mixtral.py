"""The Mixtral family: ``tpuslo_torch.models.mixtral`` against
``tpuslo.models.mixtral`` on ``mixtral_tiny``.

Both packages serve the same JAX-initialised weights in f32 on the CPU
(carried over as numpy by ``bridge``).  Tolerances: forward, prefill,
verify and decode logits 1e-4 (f32); greedy streams of the three MoE
engines (single-stream, continuous batching, paged with bf16 and int8
KV) identical, token for token; counts, caps and refusals equal.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import mixtral as jm  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import mixtral as tm  # noqa: E402

LOGIT_TOL = 1e-4
SEQ = 128
BUCKETS = (32, 64)
CHUNK = 8
CFG_J = dataclasses.replace(jm.mixtral_tiny(max_seq_len=SEQ), dtype=jnp.float32)
CFG_T = dataclasses.replace(tm.mixtral_tiny(max_seq_len=SEQ), dtype=torch.float32)
PROMPTS = ["mixture of experts", "route every token twice",
           "a longer prompt that lands in the second prefill bucket of the engine",
           "x"]
NEW_TOKENS = [12, 20, 9, 16]

_SHARED: dict = {}


def _weights():
    """(JAX params, port params), drawn once."""
    if not _SHARED:
        pj = jm.init_params(jax.random.PRNGKey(0), CFG_J)
        _SHARED["pj"] = pj
        _SHARED["pt"] = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
    return _SHARED["pj"], _SHARED["pt"]


def _engine_kw():
    return dict(prefill_buckets=BUCKETS, decode_chunk_size=CHUNK)


def _tokens(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, shape)


# --- the model ------------------------------------------------------------


def test_forward_logits_and_aux_match_jax():
    pj, pt = _weights()
    tok = _tokens(1, (2, 16))
    want, aux_j = jm.forward(pj, jnp.asarray(tok), CFG_J, remat=False, return_aux=True)
    got, aux_t = tm.forward(pt, torch.from_numpy(tok), CFG_T, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
    assert abs(float(aux_t) - float(aux_j)) < 1e-6
    assert got.shape == (2, 16, CFG_T.vocab_size)


@pytest.mark.parametrize("length,bucket", [(7, 16), (16, 16), (30, 32)])
def test_prefill_logits_and_cache_match_jax(length, bucket):
    pj, pt = _weights()
    ids = _tokens(2, (1, length))
    padded = np.concatenate([ids, np.zeros((1, bucket - length), ids.dtype)], axis=1)
    want, cj = jm.prefill(pj, jnp.asarray(padded), jl.init_kv_cache(CFG_J.attn_cfg(), 1),
                          CFG_J, true_length=jnp.asarray(length, jnp.int32))
    got, ct = tm.prefill(pt, torch.from_numpy(padded),
                         tl.init_kv_cache(CFG_T, 1, device="cpu"), CFG_T, true_length=length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
    assert int(ct["length"]) == int(cj["length"]) == length
    np.testing.assert_allclose(ct["k"][:, :, :length].numpy(),
                               np.asarray(cj["k"])[:, :, :length], atol=1e-5, rtol=0)


def _prefilled(seed: int, length: int):
    pj, pt = _weights()
    ids = _tokens(seed, (1, length))
    lj, cj = jm.prefill(pj, jnp.asarray(ids), jl.init_kv_cache(CFG_J.attn_cfg(), 1), CFG_J)
    lt, ct = tm.prefill(pt, torch.from_numpy(ids), tl.init_kv_cache(CFG_T, 1, device="cpu"),
                        CFG_T)
    return (pj, pt), (lj, cj), (lt, ct)


def test_decode_steps_match_jax():
    (pj, pt), (lj, cj), (lt, ct) = _prefilled(3, 9)
    tok = int(np.argmax(np.asarray(lj)[0]))
    for _ in range(5):
        lj, cj = jm.decode_step(pj, jnp.asarray([tok], jnp.int32), cj, CFG_J)
        lt, ct = tm.decode_step(pt, torch.tensor([tok]), ct, CFG_T)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
        tok = int(np.argmax(np.asarray(lj)[0]))
    assert int(ct["length"]) == int(cj["length"]) == 14


def test_verify_chunk_matches_jax():
    (pj, pt), (_, cj), (_, ct) = _prefilled(4, 11)
    draft = _tokens(5, (1, 4))
    want, _ = jm.verify_chunk(pj, jnp.asarray(draft), cj, CFG_J)
    got, cache = tm.verify_chunk(pt, torch.from_numpy(draft), ct, CFG_T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
    assert int(cache["length"]) == 11  # the caller decides what was accepted


def test_decode_chunk_equals_the_full_forward():
    """Incremental decode over the cache equals the full-sequence forward
    (drop-free routing)."""
    _, (_, _), (lt, ct) = _prefilled(6, 9)
    _, pt = _weights()
    toks, last, _ = tm.decode_chunk(pt, lt.argmax(dim=-1), ct, CFG_T, 6)
    seq = _tokens(6, (1, 9))[0].tolist() + [int(lt.argmax())] + toks[0, :-1].tolist()
    ref = tm.forward(pt, torch.tensor([seq]), CFG_T)[0]
    assert ref[9:].argmax(dim=-1).tolist() == toks[0].tolist()
    assert int(last[0]) == int(toks[0, -1])


def test_llama_hook_with_the_dense_mlp_keeps_the_bits():
    """``mlp_fn`` replaces only the MLP: handing the Llama paths their own
    dense MLP gives the bits of ``mlp_fn=None``."""
    cfg = dataclasses.replace(tl.llama_tiny(max_seq_len=64), dtype=torch.float32)
    params = tl.init_params(0, cfg, "cpu")
    dense = lambda layer, x: tl._dense_mlp(cfg, layer, x)  # noqa: E731
    tok = torch.from_numpy(_tokens(7, (2, 12)))
    assert torch.equal(tl.forward(params, tok, cfg), tl.forward(params, tok, cfg, mlp_fn=dense))
    outs = []
    for fn in (None, dense):
        logits, cache = tl.prefill(params, tok, tl.init_kv_cache(cfg, 2, device="cpu"), cfg,
                                   mlp_fn=fn)
        step, cache = tl.decode_step(params, logits.argmax(-1), cache, cfg, mlp_fn=fn)
        ver, _ = tl.verify_chunk(params, tok[:, :3], cache, cfg, mlp_fn=fn)
        outs.append((logits, step, ver))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --- counts, caps, weights ------------------------------------------------


@pytest.mark.parametrize("name", ["mixtral_tiny", "mixtral_2b6", "mixtral_8x7b"])
@pytest.mark.parametrize("count", ["param_count", "active_param_count"])
def test_param_counts_equal_jax(name, count):
    assert getattr(tm, count)(getattr(tm, name)()) == getattr(jm, count)(getattr(jm, name)())


def test_param_count_is_the_tree():
    cfg = tm.mixtral_tiny()
    params = tm.init_params(0, cfg, "cpu")
    leaves = [params["embed"], params["final_norm"], params["output"],
              *params["layers"].values()]
    assert sum(t.numel() for t in leaves) == tm.param_count(cfg)
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["w1"].shape == (2, 4, 64, 128)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_round_trip_is_bit_for_bit(dtype):
    """JAX tree -> port -> numpy gives JAX's leaves back exactly, with the
    router in f32 and every other leaf in the model dtype."""
    cfg_j = dataclasses.replace(CFG_J, dtype=getattr(jnp, dtype))
    cfg_t = dataclasses.replace(CFG_T, dtype=getattr(torch, dtype))
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(3), cfg_j))
    params = bridge.params_from_numpy(tree, cfg_t, "cpu")
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["w2"].dtype == getattr(torch, dtype)
    back = bridge.params_to_numpy(params)
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf, np.float32))


@pytest.mark.parametrize("seq,buckets,chunk", [(128, (32, 64), 8), (256, (32, 64, 128), 16),
                                               (64, (32, 64, 128), 16), (48, (32,), 30)])
def test_caps_equal_jax(seq, buckets, chunk):
    pj, pt = _weights()
    cj = dataclasses.replace(CFG_J, max_seq_len=seq)
    ct = dataclasses.replace(CFG_T, max_seq_len=seq)
    ej = jm.MoEServeEngine(cfg=cj, params=pj, prefill_buckets=buckets, decode_chunk_size=chunk)
    et = tm.MoEServeEngine(cfg=ct, params=pt, prefill_buckets=buckets, decode_chunk_size=chunk,
                           device="cpu")
    assert et.generation_prompt_cap() == ej.generation_prompt_cap()
    assert et.decode_chunk_size == ej.decode_chunk_size
    assert et.prefill_buckets == ej.prefill_buckets
    for n in (1, 10, 31, 40):
        assert et.decode_cap_tokens(n) == ej.decode_cap_tokens(n)


# --- the engines ----------------------------------------------------------


def _jax_engine(kv_dtype: str = "bf16"):
    key = ("jax_engine", kv_dtype)
    if key not in _SHARED:
        pj, _ = _weights()
        _SHARED[key] = jm.MoEServeEngine(cfg=CFG_J, params=pj, kv_dtype=kv_dtype,
                                         **_engine_kw())
    return _SHARED[key]


def _jax_streams(kv_dtype: str = "bf16") -> list[list[int]]:
    key = ("jax_streams", kv_dtype)
    if key not in _SHARED:
        engine = _jax_engine(kv_dtype)
        _SHARED[key] = [[e.token_id for e in engine.generate(p, n, stop_at_eos=False)]
                        for p, n in zip(PROMPTS, NEW_TOKENS)]
    return _SHARED[key]


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_serve_engine_streams_equal_jax(i):
    _, pt = _weights()
    engine = tm.MoEServeEngine(cfg=CFG_T, params=pt, device="cpu", **_engine_kw())
    events = list(engine.generate(PROMPTS[i], NEW_TOKENS[i], stop_at_eos=False))
    assert [e.token_id for e in events] == _jax_streams()[i]
    assert events[0].ttft_ms is not None and [e.index for e in events] == list(range(len(events)))


def test_prefill_ids_logits_match_jax():
    _, pt = _weights()
    ids = [256] + list(b"teacher forcing")
    want, _ = _jax_engine().prefill_ids(ids)
    got, cache = tm.MoEServeEngine(cfg=CFG_T, params=pt, device="cpu",
                                   **_engine_kw()).prefill_ids(ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
    assert cache["length"] == len(ids)


def test_warmup_and_eos_stop():
    _, pt = _weights()
    engine = tm.MoEServeEngine(cfg=CFG_T, params=pt, device="cpu", **_engine_kw())
    assert engine.warmup() > 0
    full = [e.token_id for e in engine.generate(PROMPTS[0], 12, stop_at_eos=False)]
    stopped = [e.token_id for e in engine.generate(PROMPTS[0], 12)]
    assert stopped == full[: len(stopped)]


def _drive(engine, kv_dtype: str) -> list[list[int]]:
    """Submit every prompt (two more mid-flight), run, and return the
    streams in prompt order."""
    ids = [engine.submit(p, n, stop_at_eos=False) for p, n in zip(PROMPTS[:2], NEW_TOKENS[:2])]
    engine.step()
    engine.step()
    ids += [engine.submit(p, n, stop_at_eos=False) for p, n in zip(PROMPTS[2:], NEW_TOKENS[2:])]
    results = engine.run()
    return [results[i] for i in ids]


@pytest.mark.parametrize("kind,kv_dtype", [("continuous", "bf16"), ("paged", "bf16"),
                                           ("paged", "int8"), ("continuous", "int8")])
def test_batched_engine_streams_equal_jax(kind, kv_dtype):
    """Each request's stream equals JAX's single-request MoE stream (and
    so JAX's batched engine's, which tests/test_mixtral.py holds to it)."""
    _, pt = _weights()
    if kind == "continuous":
        engine = tm.MoEContinuousBatchingEngine(cfg=CFG_T, params=pt, max_slots=3,
                                                kv_dtype=kv_dtype, device="cpu", **_engine_kw())
    else:
        engine = tm.MoEPagedBatchingEngine(cfg=CFG_T, params=pt, max_slots=3, block_size=16,
                                           kv_dtype=kv_dtype, device="cpu", **_engine_kw())
        assert not engine.pallas_attention  # the plain pool attention on the CPU
    assert _drive(engine, kv_dtype) == _jax_streams(kv_dtype)


def test_paged_engine_equals_jax_paged_engine_step_for_step():
    """The paged engines side by side under one script: every step's
    results and the block accounting agree."""
    pj, pt = _weights()
    ej = jm.MoEPagedBatchingEngine(cfg=CFG_J, params=pj, max_slots=2, block_size=16,
                                   n_blocks=12, **_engine_kw())
    et = tm.MoEPagedBatchingEngine(cfg=CFG_T, params=pt, max_slots=2, block_size=16,
                                   n_blocks=12, device="cpu", **_engine_kw())
    for e in (ej, et):
        for p, n in zip(PROMPTS, NEW_TOKENS):
            e.submit(p, n, stop_at_eos=False)
    while True:
        more_j, more_t = ej.step(), et.step()
        assert more_j == more_t
        assert et.results == ej.results
        assert et.stats()["blocks_live"] == ej.stats()["blocks_live"]
        if not more_t:
            break


# --- refusals -------------------------------------------------------------


DROPPY = dataclasses.replace(CFG_T, capacity_factor=1.0)


@pytest.mark.parametrize("cls", ["MoEContinuousBatchingEngine", "MoEPagedBatchingEngine"])
def test_batched_engines_refuse_routing_that_drops(cls):
    with pytest.raises(ValueError, match="drop-free"):
        getattr(tm, cls)(cfg=DROPPY, device="cpu")
    with pytest.raises(ValueError, match="drop-free"):
        getattr(jm, cls)(cfg=dataclasses.replace(CFG_J, capacity_factor=1.0))


@pytest.mark.parametrize("cls", ["MoEContinuousBatchingEngine", "MoEPagedBatchingEngine"])
def test_batched_engines_refuse_a_prefix_at_submit(cls):
    _, pt = _weights()
    engine = getattr(tm, cls)(cfg=CFG_T, params=pt, device="cpu", **_engine_kw())
    with pytest.raises(ValueError, match="no prefix cache"):
        engine.submit("q", 4, prefix="shared system prompt")
    assert engine.stats()["queued"] == 0


def test_serve_engine_refuses_a_prefix_and_a_mesh():
    """A prefix, and a mesh with neither a ``tp`` nor an ``ep`` axis (JAX's
    message; the tp and ep meshes themselves: ``test_torch_moe_mesh.py``)."""
    from jax.sharding import Mesh

    from tpuslo_torch.parallel import mesh as tmesh

    _, pt = _weights()
    engine = tm.MoEServeEngine(cfg=CFG_T, params=pt, device="cpu", **_engine_kw())
    with pytest.raises(ValueError, match="no prefix cache"):
        engine.ingest_prompt("q", prefix="p")
    with pytest.raises(ValueError, match="'tp' or 'ep'") as jerr:
        jm.MoEServeEngine(cfg=CFG_J, mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)))
    dp = tmesh.Mesh(None, torch.device("cpu"), backend="gloo", axes=(("dp",), (2,)))
    with pytest.raises(ValueError, match="'tp' or 'ep'") as terr:
        tm.MoEServeEngine(cfg=CFG_T, params=pt, device="cpu", mesh=dp)
    assert str(terr.value) == str(jerr.value)


def test_paged_engine_refuses_bad_block_geometry_before_building():
    with pytest.raises(ValueError, match="multiple"):
        tm.MoEPagedBatchingEngine(cfg=CFG_T, block_size=48, device="cpu")


def test_engines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MoEServeEngine(cfg=CFG_T)
