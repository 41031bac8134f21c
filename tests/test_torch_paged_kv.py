"""Paged KV pool: ``tpuslo_torch.models.paged_kv`` against the JAX engine.

Both engines serve the same JAX-initialised weights (carried over as
numpy) in f32 on the CPU through the same submit/step script: streams,
block accounting, backpressure and shared-prefix sharing must agree.
Streams must be identical; a divergence is accepted only where JAX's
single-request top-2 margin at that position is a tie (under
``2 * 1e-4``).  With ``pallas_attention=True`` the port runs K2's plain
version on the CPU and JAX runs its Pallas kernel in interpret mode.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import kv_cache as jkv  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import paged_kv as jpk  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import paged_kv as tpk  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.ops import paged_attention as tpa  # noqa: E402

LOGIT_TOL = 1e-4
CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=128), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=torch.float32)

_SHARED: dict = {}


def _weights():
    """(JAX params, port params, {kv_dtype: JAX single-request engine})."""
    if not _SHARED:
        pj = jl.init_params(jax.random.PRNGKey(0), CFG_J)
        _SHARED["pj"] = pj
        _SHARED["pt"] = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
        _SHARED["single"] = {}
    return _SHARED["pj"], _SHARED["pt"], _SHARED["single"]


def _single(kv_dtype="bf16"):
    pj, _, single = _weights()
    if kv_dtype not in single:
        single[kv_dtype] = js.ServeEngine(cfg=CFG_J, params=pj, kv_dtype=kv_dtype)
    return single[kv_dtype]


def _pair(**kw):
    pj, pt, _ = _weights()
    return (
        jpk.PagedBatchingEngine(cfg=CFG_J, params=pj, **kw),
        tpk.PagedBatchingEngine(cfg=CFG_T, params=pt, device="cpu", **kw),
    )


def _port(**kw):
    _, pt, _ = _weights()
    return tpk.PagedBatchingEngine(cfg=CFG_T, params=pt, device="cpu", **kw)


def _ids(prompt, prefix):
    if prefix:
        p_ids, s_ids = ts.prefix_prompt_ids(prefix, prompt, CFG_T.max_seq_len)
        return p_ids + s_ids
    return ts.encode_bytes(prompt, CFG_T.max_seq_len - 2)


def _assert_same_stream(ids, want, got, kv_dtype="bf16"):
    """Identical, or diverging only where JAX's top-2 margin is a tie."""
    assert len(got) == len(want), (want, got)
    for k, (a, b) in enumerate(zip(want, got)):
        if a != b:
            logits, _ = _single(kv_dtype).ingest_ids(ids + want[:k])
            top2 = np.sort(np.asarray(logits[0], np.float32))[-2:]
            assert top2[1] - top2[0] < 2 * LOGIT_TOL, (k, want, got)
            return


def _sub(prompt, n, prefix=None):
    return ("submit", dict(prompt=prompt, max_new_tokens=n, prefix=prefix))


def _drive(engines, script, run=True):
    meta = {}
    for eng in engines:
        for op, arg in script:
            if op == "submit":
                meta[eng.submit(**arg)] = (arg["prompt"], arg.get("prefix"))
            else:
                for _ in range(arg):
                    eng.step()
        if run:
            eng.run()
    return meta


def _assert_agree(ej, et, meta, kv_dtype="bf16"):
    assert sorted(et.results) == sorted(ej.results)
    for rid, (prompt, prefix) in meta.items():
        if rid in ej.results:
            _assert_same_stream(
                _ids(prompt, prefix), ej.results[rid], et.results[rid], kv_dtype
            )
    assert et.stats() == ej.stats()
    assert sorted(et._free) == sorted(ej._free)


def _plain_stream(et, prompt, n, prefix=None, kv_dtype="bf16"):
    single = ts.ServeEngine(cfg=CFG_T, params=et.params, kv_dtype=kv_dtype, device="cpu")
    return [e.token_id for e in single.generate(prompt, n, prefix=prefix)]


# -- engine parity -------------------------------------------------------


def test_paged_matches_jax_and_single_request_serving():
    ej, et = _pair(max_slots=2, block_size=16)
    prompts = ["hello world", "a much longer second prompt here", "third"]
    meta = _drive((ej, et), [_sub(p, 8) for p in prompts])
    _assert_agree(ej, et, meta)
    for rid, prompt in enumerate(prompts):
        assert et.results[rid] == _plain_stream(et, prompt, 8)


def test_generation_crosses_block_boundaries():
    ej, et = _pair(max_slots=1, block_size=16)
    meta = _drive((ej, et), [_sub("x" * 19, 24)])
    _assert_agree(ej, et, meta)


def test_int8_pool_composes():
    ej, et = _pair(max_slots=2, block_size=16, kv_dtype="int8")
    meta = _drive((ej, et), [_sub("alpha", 8), _sub("beta prompt", 8)])
    _assert_agree(ej, et, meta, kv_dtype="int8")


def test_block_accounting_and_release():
    ej, et = _pair(max_slots=2, block_size=16, n_blocks=9)
    assert len(et._free) == 8
    meta = _drive((ej, et), [_sub("abcd", 8), _sub("abcd", 8), ("step", 1)], run=False)
    assert et.stats()["blocks_live"] == 2 == ej.stats()["blocks_live"]
    ej.run()
    et.run()
    _assert_agree(ej, et, meta)
    assert len(et._free) == 8


def test_admission_backpressure_then_progress():
    ej, et = _pair(max_slots=2, block_size=32, n_blocks=5)
    meta = _drive((ej, et), [_sub("p" * 36, 28), _sub("q" * 36, 28), ("step", 1)], run=False)
    assert et.stats()["active_slots"] == 1 and et.stats()["queued"] == 1
    assert et.stats() == ej.stats()
    ej.run()
    et.run()
    _assert_agree(ej, et, meta)


def test_never_admittable_request_raises():
    et = _port(max_slots=1, block_size=16, n_blocks=3)
    et.submit("z" * 40, max_new_tokens=30)
    with pytest.raises(ValueError, match="blocks"):
        et.run()


def test_stale_page_table_cannot_corrupt_reallocated_blocks():
    ej, et = _pair(max_slots=3, block_size=16, n_blocks=10)
    meta = _drive((ej, et), [
        _sub("aaaa", 4), _sub("bbbb", 4), _sub("d" * 30, 40), ("step", 8),
        _sub("c" * 40, 24),
    ])
    _assert_agree(ej, et, meta)
    assert et.results[3] == _plain_stream(et, "c" * 40, 24)


def test_capacity_blocked_request_prefills_once():
    et = _port(max_slots=2, block_size=32, n_blocks=5)
    calls = {"n": 0}
    real = et._ingest.ingest_prompt

    def counting(prompt, prefix=None):
        calls["n"] += 1
        return real(prompt, prefix)

    et._ingest.ingest_prompt = counting
    ids = [et.submit("p" * 36, max_new_tokens=28) for _ in range(2)]
    assert set(et.run()) == set(ids)
    assert calls["n"] == 2


def test_cancel_releases_blocks():
    et = _port(max_slots=2, block_size=16)
    free0 = len(et._free)
    rid = et.submit("some prompt", max_new_tokens=20)
    et.step()
    assert len(et._free) < free0
    et.cancel(rid)
    assert len(et._free) == free0
    assert int(et._cache["length"][0]) == 0
    assert not et._cache["page_table"][0].any()


def test_capacity_win_vs_dense_reservation():
    slots, bs = 8, 16
    dense = tl.kv_cache_bytes(CFG_T, slots)
    n_blocks = 1 + (slots * (CFG_T.max_seq_len // bs)) // 2
    paged = tpk.paged_pool_bytes(CFG_T, n_blocks, bs)
    assert paged == jpk.paged_pool_bytes(CFG_J, n_blocks, bs)
    assert paged <= dense * 0.52
    assert dense / tpk.paged_pool_bytes(CFG_T, n_blocks, bs, kv_dtype="int8") > 3.0
    ej, et = _pair(max_slots=slots, block_size=bs, n_blocks=n_blocks)
    meta = _drive((ej, et), [_sub(f"request number {i}", 8) for i in range(slots)])
    _assert_agree(ej, et, meta)


def test_pool_structure():
    state = tpk.init_paged_pool(CFG_T, 9, 16, 4, device="cpu")
    assert tuple(state["k"].shape) == (CFG_T.n_layers, 9, 16, CFG_T.n_kv_heads, CFG_T.head_dim)
    assert state["page_table"].shape == (4, CFG_T.max_seq_len // 16)
    assert state["page_table"].dtype == torch.int32
    assert state["length"].shape == (4,)
    q = tpk.init_paged_pool(CFG_T, 9, 16, 4, kv_dtype="int8", device="cpu")
    assert q["k"]["q"].dtype == torch.int8 and q["k"]["s"].shape == (2, 9, 16, 2)


def test_paged_with_prefix_cache():
    ej, et = _pair(max_slots=2, block_size=16)
    meta = _drive((ej, et), [_sub("what is ttft?", 8, prefix="system: terse answers. ")])
    _assert_agree(ej, et, meta)


@pytest.mark.parametrize("block_size,match", [(24, "multiple"), (256, "exceeds")])
def test_bad_block_geometry_rejected(block_size, match):
    _, pt, _ = _weights()
    with pytest.raises(ValueError, match=match):
        tpk.PagedBatchingEngine(cfg=CFG_T, params=pt, block_size=block_size, device="cpu")


def test_parked_lane_past_table_width_writes_only_null_block():
    """Released lanes keep stepping and their lengths walk past the
    page-table width: every write still lands in null block 0."""
    _, pt, _ = _weights()
    bs = 16
    mb = CFG_T.max_seq_len // bs
    state = tpk.init_paged_pool(CFG_T, n_blocks=5, block_size=bs, slots=2, device="cpu")
    token = torch.zeros((2,), dtype=torch.long)
    steps = mb * bs + 12
    for _ in range(steps):
        logits, state = tpk.paged_decode_step(pt, token, state, CFG_T, bs)
    assert int(state["length"][0]) == steps
    assert torch.isfinite(logits).all()
    assert state["k"][:, 1:].abs().max() == 0.0
    assert state["k"][:, 0].abs().max() > 0.0


# -- shared prefix blocks (block-granular copy-on-write) ----------------


def test_shared_prefix_token_parity():
    ej, et = _pair(max_slots=3, block_size=16)
    prefix = "system: answer tersely and truthfully. "  # 40 ids: 2 full blocks
    script = [_sub(s, 8, prefix) for s in ("what is ttft?", "define mfu", "name one tpu signal")]
    meta = _drive((ej, et), script + [_sub("no prefix here", 8)])
    _assert_agree(ej, et, meta)
    stats = et.stats()
    assert stats["shared_prefix_blocks"] == 2 and stats["shared_prefixes"] == 1
    assert stats["prefix_reuse_hits"] >= 2


def test_shared_prefix_capacity_win():
    prefix = "P" * 31  # 32 ids: 2 full blocks of 16
    kw = dict(max_slots=2, block_size=16, n_blocks=5)
    unshared = _port(share_prefixes=False, **kw)
    for s in ("aaaaaaaa", "bbbbbbbb"):
        unshared.submit(s, max_new_tokens=8, prefix=prefix)
    unshared.step()
    assert unshared.stats()["active_slots"] == 1
    ej, et = _pair(**kw)
    meta = _drive((ej, et), [_sub("aaaaaaaa", 8, prefix), _sub("bbbbbbbb", 8, prefix), ("step", 1)], run=False)
    assert et.stats()["active_slots"] == 2 == ej.stats()["active_slots"]
    ej.run()
    et.run()
    _assert_agree(ej, et, meta)
    assert unshared.run()[0] == et.results[0]


def test_shared_prefix_warm_reuse_and_eviction():
    ej, et = _pair(max_slots=2, block_size=16, n_blocks=8)
    prefix = "S" * 32  # 33 ids: 2 full blocks
    meta = _drive((ej, et), [_sub("first", 4, prefix)])
    assert len(et._free) == 7 - 2
    entry = et._shared_prefixes[prefix]
    assert entry.refs == 0 and entry.populated
    meta.update(_drive((ej, et), [_sub("second", 4, prefix)]))
    assert et.prefix_reuse_hits == 1 == ej.prefix_reuse_hits
    meta.update(_drive((ej, et), [_sub("z" * 60, 40)]))  # 7 blocks: evicts
    _assert_agree(ej, et, meta)
    assert prefix not in et._shared_prefixes and len(et._free) == 7


def test_shared_prefix_never_evicted_while_referenced():
    prefix = "Q" * 32
    ej, et = _pair(max_slots=2, block_size=16, n_blocks=6)
    meta = _drive((ej, et), [_sub("aaaaaaaa", 24, prefix), ("step", 1), _sub("y" * 40, 24), ("step", 1)], run=False)
    assert prefix in et._shared_prefixes and et.stats()["queued"] == 1
    assert et.stats() == ej.stats()
    ej.run()
    et.run()
    _assert_agree(ej, et, meta)


def test_shared_prefix_two_prefixes_isolated():
    ej, et = _pair(max_slots=2, block_size=16)
    meta = _drive((ej, et), [_sub("one", 8, "alpha " * 6), _sub("two", 8, "omega " * 6)])
    _assert_agree(ej, et, meta)
    assert et.stats()["shared_prefixes"] == 2


def test_shared_prefix_int8_compose():
    ej, et = _pair(max_slots=2, block_size=16, kv_dtype="int8")
    prefix = "system: terse. " * 3
    meta = _drive((ej, et), [_sub("left", 8, prefix), _sub("right", 8, prefix)])
    _assert_agree(ej, et, meta, kv_dtype="int8")
    assert et.prefix_reuse_hits == 1


def test_eviction_never_victimizes_the_prefix_being_admitted():
    ej, et = _pair(max_slots=2, block_size=16, n_blocks=5)
    p, q = "P" * 15, "Q" * 15  # 16 ids each: 1 full block
    meta = _drive((ej, et), [_sub("aaaaaaaa", 8, p)])
    meta.update(_drive((ej, et), [_sub("bbbbbbbb", 8, q)]))
    assert len(et._free) == 2
    meta.update(_drive((ej, et), [_sub("c" * 20, 28, p)]))
    _assert_agree(ej, et, meta)
    assert et.prefix_reuse_hits == 1
    assert p in et._shared_prefixes and q not in et._shared_prefixes


def test_never_admittable_raises_even_with_warm_share():
    et = _port(max_slots=2, block_size=16, n_blocks=5)
    prefix = "R" * 31
    et.submit("warm", max_new_tokens=4, prefix=prefix)
    et.run()
    assert prefix in et._shared_prefixes
    et.submit("overflow", max_new_tokens=40, prefix=prefix)
    with pytest.raises(ValueError, match="blocks"):
        et.run()


# -- the K2 switch --------------------------------------------------------


def test_pallas_switch_matches_jax_pallas_engine():
    """``pallas_attention=True``: the port's K2 route (its plain version
    on the CPU) against JAX's Pallas kernel (interpret), with shared
    prefix blocks and a plain request in flight together."""
    ej, et = _pair(max_slots=3, block_size=16, pallas_attention=True)
    assert et.pallas_attention and ej.pallas_attention
    prefix = "system: pallas shared prefix. "  # 31 ids: 1 full block
    before = tpa.paged_decode_attention.launches
    meta = _drive((ej, et), [
        _sub("kernel one", 8, prefix), _sub("kernel two", 8, prefix),
        _sub("a second longer request prompt", 8),
    ])
    _assert_agree(ej, et, meta)
    assert et.prefix_reuse_hits >= 1
    assert tpa.paged_decode_attention.launches == before  # CPU: plain version
    for rid, (prompt, pre) in meta.items():
        assert et.results[rid] == _plain_stream(et, prompt, 8, prefix=pre)


def test_bf16_pallas_engine_matches_jax_pallas_engine():
    """JAX's ``test_engine_pallas_path_token_parity`` mirrored: bf16
    ``llama_tiny`` (head dim 16, which K2 is not built for: on a card the
    switch takes K2-f32) with ``pallas_attention=True``, the port's engine
    (K2's plain version on the CPU) against JAX's (the Pallas kernel in
    interpret mode) on the same weights and submit script.  Both models
    round in bf16, in other places, so a stream may leave JAX's only where
    JAX's single-request top-2 margin is under 0.15, the JAX test's rule."""
    cfg_j = jl.llama_tiny(max_seq_len=128)
    cfg_t = tl.llama_tiny(max_seq_len=128)
    assert cfg_t.dtype == torch.bfloat16 and cfg_t.head_dim == 16
    pj = jl.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, "cpu")
    kw = dict(max_slots=2, block_size=16, pallas_attention=True)
    ej = jpk.PagedBatchingEngine(cfg=cfg_j, params=pj, **kw)
    et = tpk.PagedBatchingEngine(cfg=cfg_t, params=pt, device="cpu", **kw)
    prompts = ["pallas paged", "a second longer request prompt"]
    before = (tpa.paged_decode_attention.launches, tpa.paged_decode_attention.f32_launches)
    meta = _drive((ej, et), [_sub(p, 8) for p in prompts])
    assert (tpa.paged_decode_attention.launches,
            tpa.paged_decode_attention.f32_launches) == before  # CPU: plain version
    assert sorted(et.results) == sorted(ej.results) and et.stats() == ej.stats()
    single = js.ServeEngine(cfg=cfg_j, params=pj)
    for rid, (prompt, _) in meta.items():
        want, got = ej.results[rid], et.results[rid]
        assert len(got) == len(want)
        for k, (a, b) in enumerate(zip(want, got)):
            if a != b:
                ids = ts.encode_bytes(prompt, cfg_t.max_seq_len - 2) + want[:k]
                logits, _ = single.prefill_ids(ids)
                top2 = np.sort(np.asarray(logits[0], np.float32))[-2:]
                assert top2[1] - top2[0] < 0.15, (prompt, k, want, got)
                break


def test_pallas_switch_reads_the_environment(monkeypatch):
    _, pt, _ = _weights()
    monkeypatch.setenv("TPUSLO_PAGED_PALLAS", "1")
    assert tpk.PagedBatchingEngine(cfg=CFG_T, params=pt, block_size=16, device="cpu").pallas_attention
    monkeypatch.setenv("TPUSLO_PAGED_PALLAS", "0")
    assert not tpk.PagedBatchingEngine(cfg=CFG_T, params=pt, block_size=16, device="cpu").pallas_attention
    engine = tpk.PagedBatchingEngine(
        cfg=CFG_T, params=pt, block_size=16, pallas_attention=True, device="cpu"
    )
    assert engine.pallas_attention


def test_out_of_scope_and_cardless_paths_raise(monkeypatch):
    _, pt, _ = _weights()
    with pytest.raises(ValueError, match="must divide"):  # tp 4 over 2 kv heads
        tpk.PagedBatchingEngine(cfg=CFG_T, params=pt, device="cpu",
                                mesh=tmesh.Mesh(tmesh.MeshPlan(tp=4), torch.device("cpu"),
                                                backend="gloo"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpk.PagedBatchingEngine(cfg=tl.llama_tiny(max_seq_len=64), block_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpk.init_paged_pool(CFG_T, 3, 16, 1)


# -- the decode step and block moves, state for state -------------------


def _jax_state(kv_dtype, seed, n_blocks=9, bs=16, slots=3):
    """A JAX paged state with random pool contents, two live lanes (one
    past a block boundary, sharing the other's first block) and a
    parked lane."""
    rng = np.random.RandomState(seed)
    state = jpk.init_paged_pool(CFG_J, n_blocks, bs, slots, kv_dtype=kv_dtype)
    shape = (CFG_J.n_layers, n_blocks, bs, CFG_J.n_kv_heads, CFG_J.head_dim)
    for side in ("k", "v"):
        x = jnp.asarray(rng.randn(*shape), jnp.float32)
        state[side] = jkv.quantize_kv(x) if kv_dtype == "int8" else x
    table = np.zeros((slots, CFG_J.max_seq_len // bs), np.int32)
    table[0, :3] = [3, 5, 7]
    table[1, :2] = [3, 2]
    state["page_table"] = jnp.asarray(table)
    state["length"] = jnp.asarray([37, 20, 5], jnp.int32)
    return state


def _assert_state_equal(got: dict, want: dict, atol: float):
    for side in ("k", "v"):
        if isinstance(want[side], dict):
            np.testing.assert_array_equal(got[side]["s"] == 0, want[side]["s"] == 0)
            np.testing.assert_allclose(got[side]["s"], want[side]["s"], rtol=1e-6)
            assert np.mean(got[side]["q"] != want[side]["q"]) < 0.01
            assert np.abs(got[side]["q"].astype(int) - want[side]["q"]).max() <= 1
        else:
            np.testing.assert_allclose(got[side], want[side], atol=atol)
    np.testing.assert_array_equal(got["page_table"], want["page_table"])
    np.testing.assert_array_equal(got["length"], want["length"])


@pytest.mark.parametrize("kv_dtype,pallas", [("bf16", False), ("bf16", True), ("int8", True)])
def test_decode_step_state_matches_jax(kv_dtype, pallas):
    """Three paged_decode_steps from the same state: pool, page table
    and lengths carried back through the bridge equal JAX's, and so do
    the logits.  int8 codes may differ by one step at < 1% of entries
    (values within ~1e-6 of a rounding boundary)."""
    pj, pt, _ = _weights()
    js_ = _jax_state(kv_dtype, seed=7)
    ts_ = bridge.paged_state_from_numpy(jax.tree.map(np.asarray, js_), CFG_T, "cpu")
    tokens = np.asarray([5, 300, 17])
    jstep = jax.jit(lambda p, t, s: jpk.paged_decode_step(p, t, s, CFG_J, 16, pallas=pallas))
    for _ in range(3):
        jl_, js_ = jstep(pj, jnp.asarray(tokens, jnp.int32), js_)
        tl_, ts_ = tpk.paged_decode_step(
            pt, torch.from_numpy(tokens), ts_, CFG_T, 16, pallas=pallas
        )
        np.testing.assert_allclose(tl_[:2].numpy(), np.asarray(jl_)[:2], atol=5e-4)
        tokens = np.asarray(jl_).argmax(-1)
    _assert_state_equal(
        bridge.paged_state_to_numpy(ts_), jax.tree.map(np.asarray, js_), atol=1e-4
    )


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_park_resume_and_gather_match_jax(kv_dtype):
    rng = np.random.RandomState(11)
    bs, bucket = 16, 2
    pool_j = _jax_state("int8" if kv_dtype == "int8" else "bf16", seed=12)
    shape = (CFG_J.n_layers, 2, CFG_J.max_seq_len, CFG_J.n_kv_heads, CFG_J.head_dim)
    dense = {s: jnp.asarray(rng.randn(*shape), jnp.float32) for s in ("k", "v")}
    if kv_dtype == "int8":
        dense = {s: jkv.quantize_kv(a) for s, a in dense.items()}
    cache_j = {**dense, "length": jnp.asarray([21, 9], jnp.int32)}
    pool_t = bridge.paged_state_from_numpy(jax.tree.map(np.asarray, pool_j), CFG_T, "cpu")
    cache_t = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache_j), CFG_T, "cpu")
    phys = np.asarray([6, 4], np.int32)

    pool_j = jpk.park_slot_blocks(pool_j, cache_j, 1, jnp.asarray(phys), CFG_J, bs, bucket)
    pool_t = tpk.park_slot_blocks(pool_t, cache_t, 1, torch.from_numpy(phys), CFG_T, bs, bucket)
    _assert_state_equal(
        bridge.paged_state_to_numpy(pool_t), jax.tree.map(np.asarray, pool_j), atol=0
    )

    cache_j = jpk.resume_slot_blocks(cache_j, pool_j, 0, jnp.asarray(phys), 30, CFG_J, bs, bucket)
    cache_t = tpk.resume_slot_blocks(cache_t, pool_t, 0, torch.from_numpy(phys), 30, CFG_T, bs, bucket)
    got, want = bridge.cache_to_numpy(cache_t), jax.tree.map(np.asarray, cache_j)
    np.testing.assert_array_equal(got["length"], want["length"])
    for side in ("k", "v"):
        for leaf in (("q", "s") if kv_dtype == "int8" else (None,)):
            g = got[side][leaf] if leaf else got[side]
            w = want[side][leaf] if leaf else want[side]
            np.testing.assert_array_equal(g, w)

    table = np.zeros((CFG_J.max_seq_len // bs,), np.int32)
    table[:2] = phys
    row_j = jpk.gather_parked_row(pool_j, jnp.asarray(table), 30, CFG_J, bs)
    row_t = tpk.gather_parked_row(pool_t, torch.from_numpy(table), 30, CFG_T, bs)
    got, want = bridge.cache_to_numpy(row_t), jax.tree.map(np.asarray, row_j)
    assert int(got["length"]) == int(want["length"]) == 30
    for side in ("k", "v"):
        for leaf in (("q", "s") if kv_dtype == "int8" else (None,)):
            g = got[side][leaf] if leaf else got[side]
            w = want[side][leaf] if leaf else want[side]
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8"])
def test_bridge_round_trips_state(kv_dtype):
    """Dense caches and paged states, numpy -> port -> numpy, exactly
    (bf16 through f32 is exact for bf16 values)."""
    cfg = CFG_T if kv_dtype != "bf16" else tl.llama_tiny(max_seq_len=128)
    state = _jax_state("int8" if kv_dtype == "int8" else "bf16", seed=3)
    tree = jax.tree.map(np.asarray, state)
    if kv_dtype == "bf16":
        tree = {**tree, "k": tree["k"].astype(jnp.bfloat16).astype(np.float32),
                "v": tree["v"].astype(jnp.bfloat16).astype(np.float32)}
    back = bridge.paged_state_to_numpy(bridge.paged_state_from_numpy(tree, cfg, "cpu"))
    _assert_state_equal(back, tree, atol=0)
    if kv_dtype == "int8":
        assert back["k"]["q"].dtype == np.int8
    dense = {"k": tree["k"], "v": tree["v"], "length": np.asarray([3, 4, 5])}
    again = bridge.cache_to_numpy(bridge.cache_from_numpy(dense, cfg, "cpu"))
    np.testing.assert_array_equal(again["length"], [3, 4, 5])
    scalar = bridge.cache_from_numpy({**dense, "length": np.asarray(7)}, cfg, "cpu")
    assert scalar["length"] == 7
