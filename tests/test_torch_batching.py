"""Continuous batching: ``tpuslo_torch.models.batching`` against the JAX engine.

Both engines serve the same JAX-initialised weights (carried over as
numpy) in f32 on the CPU, driven through the same submit/step script.
Per-request streams must be identical; a divergence is accepted only
where JAX's single-request top-2 margin at that position is a tie
(under ``2 * 1e-4``), the rule of ``tests/test_torch_serve.py``.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import batching as jb  # noqa: E402
from tpuslo.models import kv_cache as jkv  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo_torch.models import batching as tb  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import kv_cache as tkv  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402

LOGIT_TOL = 1e-4
CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=128), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=torch.float32)

_SHARED: dict = {}


def _weights():
    """(JAX params, port params, JAX single-request engine), built once."""
    if not _SHARED:
        pj = jl.init_params(jax.random.PRNGKey(0), CFG_J)
        _SHARED["pj"] = pj
        _SHARED["pt"] = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
        _SHARED["single"] = js.ServeEngine(cfg=CFG_J, params=pj)
    return _SHARED["pj"], _SHARED["pt"], _SHARED["single"]


def _pair(**kw):
    pj, pt, _ = _weights()
    return (
        jb.ContinuousBatchingEngine(cfg=CFG_J, params=pj, **kw),
        tb.ContinuousBatchingEngine(cfg=CFG_T, params=pt, device="cpu", **kw),
    )


def _ids(prompt: str, prefix: str | None) -> list[int]:
    if prefix:
        p_ids, s_ids = ts.prefix_prompt_ids(prefix, prompt, CFG_T.max_seq_len)
        return p_ids + s_ids
    return ts.encode_bytes(prompt, CFG_T.max_seq_len - 2)


def _assert_same_stream(ids, want: list[int], got: list[int]):
    """Identical, or diverging only where JAX's top-2 margin is a tie."""
    _, _, single = _weights()
    assert len(got) == len(want), (want, got)
    for k, (a, b) in enumerate(zip(want, got)):
        if a != b:
            logits, _ = single.ingest_ids(ids + want[:k])
            top2 = np.sort(np.asarray(logits[0], np.float32))[-2:]
            assert top2[1] - top2[0] < 2 * LOGIT_TOL, (k, want, got)
            return


def _drive(engines, script):
    """Run one script on both engines: a list of ("submit", kwargs) and
    ("step", n) entries, then ``run()``.  Returns the submitted
    (prompt, prefix) per request id and each engine's results."""
    meta = {}
    for eng in engines:
        for op, arg in script:
            if op == "submit":
                rid = eng.submit(**arg)
                meta[rid] = (arg["prompt"], arg.get("prefix"))
            else:
                for _ in range(arg):
                    eng.step()
        eng.run()
    return meta


def _assert_engines_agree(ej, et, meta):
    assert sorted(et.results) == sorted(ej.results)
    for rid, (prompt, prefix) in meta.items():
        if rid in ej.results:
            _assert_same_stream(_ids(prompt, prefix), ej.results[rid], et.results[rid])


def _sub(prompt, n, prefix=None, stop=False):
    return ("submit", dict(prompt=prompt, max_new_tokens=n, stop_at_eos=stop, prefix=prefix))


def test_requests_match_jax_engine_and_single_request_serving():
    ej, et = _pair(max_slots=2)
    prompts = ["alpha", "a much longer prompt with more bytes", "z"]
    meta = _drive((ej, et), [_sub(p, 10) for p in prompts])
    _assert_engines_agree(ej, et, meta)
    single = ts.ServeEngine(cfg=CFG_T, params=et.params, device="cpu")
    for rid, prompt in enumerate(prompts):
        plain = [e.token_id for e in single.generate(prompt, 10, stop_at_eos=False)]
        assert et.results[rid] == plain
    assert et.steps == ej.steps


def test_more_requests_than_slots_queue_and_reuse():
    ej, et = _pair(max_slots=2)
    meta = _drive((ej, et), [_sub(f"req {i}", 4 + i) for i in range(5)])
    _assert_engines_agree(ej, et, meta)
    for i in range(5):
        assert len(et.results[i]) == 4 + i
    assert et.steps == ej.steps < sum(4 + i for i in range(5))


def test_single_token_and_instant_requests_never_dispatch_decode():
    ej, et = _pair(max_slots=2)
    meta = _drive((ej, et), [_sub(f"i{n}", 1) for n in range(3)])
    _assert_engines_agree(ej, et, meta)
    assert et.steps == ej.steps == 0
    assert all(len(t) == 1 for t in et.results.values())


def test_interleaved_admission_does_not_disturb_running_rows():
    ej, et = _pair(max_slots=2)
    meta = _drive((ej, et), [
        _sub("steady request", 12), ("step", 4), _sub("late arrival", 6),
    ])
    _assert_engines_agree(ej, et, meta)


def test_budget_capped_near_capacity():
    """121 prompt ids in a 128-position cache: both engines cap the
    budget at 6 and never write past the end."""
    ej, et = _pair(max_slots=1)
    meta = _drive((ej, et), [_sub("p" * 120, 50)])
    _assert_engines_agree(ej, et, meta)
    assert len(et.results[0]) == 128 - 121 - 1


def test_released_lane_past_max_seq_len_keeps_live_streams():
    """A request parks at length ~125 of a 128-position cache while the
    other slot decodes on: the released lane walks past the cache end.
    JAX drops those writes; the port must too (not raise), and the live
    stream must not change."""
    ej, et = _pair(max_slots=2)
    meta = _drive((ej, et), [_sub("p" * 120, 4), _sub("live", 40)])
    _assert_engines_agree(ej, et, meta)
    assert len(et.results[1]) == 40
    # The released slot 0 really walked past the end of its cache.
    assert int(et._cache["length"][0]) > CFG_T.max_seq_len
    assert int(et._cache["length"][0]) == int(ej._cache["length"][0])


def test_stats_reflect_lifecycle():
    ej, et = _pair(max_slots=2)
    assert et.stats() == ej.stats() == {
        "active_slots": 0, "max_slots": 2, "occupancy": 0.0,
        "queued": 0, "steps": 0, "completed": 0,
    }
    for eng in (ej, et):
        eng.submit("a", max_new_tokens=6, stop_at_eos=False)
        eng.submit("b", max_new_tokens=6, stop_at_eos=False)
        eng.step()
    assert et.stats() == ej.stats()
    assert et.stats()["occupancy"] == 1.0
    ej.run()
    et.run()
    assert et.stats() == ej.stats()
    assert et.stats()["completed"] == 2


def test_partial_tokens_streams_per_step():
    ej, et = _pair(max_slots=2)
    rj = ej.submit("stream me", max_new_tokens=6, stop_at_eos=False)
    rt = et.submit("stream me", max_new_tokens=6, stop_at_eos=False)
    assert et.partial_tokens(rt) == [] == ej.partial_tokens(rj)
    grew = 0
    while rt not in et.results:
        before = len(et.partial_tokens(rt))
        et.step()
        ej.step()
        assert et.partial_tokens(rt) == ej.partial_tokens(rj)
        grew += len(et.partial_tokens(rt)) > before
    assert grew >= 2
    assert et.partial_tokens(rt) == et.results[rt]
    assert et.partial_tokens(99999) is None


def test_cancel_releases_queue_slot_and_results():
    _, et = _pair(max_slots=1)
    keep = et.submit("keep", max_new_tokens=4, stop_at_eos=False)
    drop = et.submit("drop", max_new_tokens=4, stop_at_eos=False)
    et.step()
    et.cancel(drop)
    assert et.partial_tokens(drop) is None
    et.run()
    assert keep in et.results and drop not in et.results
    et.cancel(keep)
    assert keep not in et.results
    et.cancel(keep)  # idempotent


def test_cancel_of_a_running_request_frees_its_slot():
    _, et = _pair(max_slots=1)
    rid = et.submit("running", max_new_tokens=20, stop_at_eos=False)
    et.step()
    et.cancel(rid)
    assert et.stats()["active_slots"] == 0
    nxt = et.submit("next", max_new_tokens=3, stop_at_eos=False)
    et.run()
    assert rid not in et.results and len(et.results[nxt]) == 3


def test_prefix_requests_match_jax():
    ej, et = _pair(max_slots=2)
    sys_prompt = "system: terse answers only. "
    meta = _drive((ej, et), [
        _sub("what is ttft?", 8, prefix=sys_prompt),
        _sub("plain request", 8),
        ("step", 3),
        _sub("second prefixed", 6, prefix=sys_prompt),
    ])
    _assert_engines_agree(ej, et, meta)
    assert list(et._ingest._prefix_cache) == [sys_prompt]


def test_request_timings_record_queue_delay_and_e2e():
    _, et = _pair(max_slots=2)
    ids = [et.submit(f"request {i}", max_new_tokens=6, stop_at_eos=False) for i in range(5)]
    one = et.submit("one token", max_new_tokens=1, stop_at_eos=False)
    et.run()
    timings = et.request_timings()
    assert sorted(timings) == sorted(ids + [one])
    for t in timings.values():
        assert 0.0 <= t["queue_delay_s"] <= t["e2e_s"]
    first_wave = min(timings[i]["queue_delay_s"] for i in ids[:2])
    assert timings[ids[4]]["queue_delay_s"] > first_wave


def test_bad_arguments_raise():
    _, pt, _ = _weights()
    with pytest.raises(ValueError, match="max_slots"):
        tb.ContinuousBatchingEngine(cfg=CFG_T, params=pt, max_slots=0, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        tb.ContinuousBatchingEngine(cfg=CFG_T, params=pt, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        tb.ContinuousBatchingEngine(cfg=CFG_T, params=pt, kv_dtype="fp8", device="cpu")


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.ContinuousBatchingEngine(cfg=tl.llama_tiny(max_seq_len=64))


def test_family_hooks_ride_the_scheduler():
    """``ingest=`` and ``step_fn=`` replace the prompt ingester and the
    per-step decode; the scheduler calls them and nothing else."""
    _, et = _pair(max_slots=2)
    calls = {"step": 0}

    def step_fn(params, tokens, cache):
        calls["step"] += 1
        return tl.decode_step(params, tokens, cache, CFG_T)

    hooked = tb.ContinuousBatchingEngine(
        cfg=CFG_T, max_slots=2, ingest=et._ingest, step_fn=step_fn, device="cpu"
    )
    assert hooked.params is et.params
    rid = hooked.submit("hooked", max_new_tokens=5, stop_at_eos=False)
    hooked.run()
    assert calls["step"] == hooked.steps == 4
    single = ts.ServeEngine(cfg=CFG_T, params=et.params, device="cpu")
    assert hooked.results[rid] == [
        e.token_id for e in single.generate("hooked", 5, stop_at_eos=False)
    ]


# -- row splices and the out-of-range row write ---------------------------


def _caches(kv_dtype, B, seed):
    """A random JAX cache (L, B, S, KV, HD) and the port's copy of it."""
    rng = np.random.RandomState(seed)
    shape = (2, B, 16, 2, 8)
    x = {s: jnp.asarray(rng.randn(*shape), jnp.float32) for s in ("k", "v")}
    if kv_dtype == "int8":
        x = {s: jkv.quantize_kv(a) for s, a in x.items()}
    lengths = jnp.asarray(rng.randint(1, 16, size=(B,)), jnp.int32)
    jc = {**x, "length": lengths}
    tc = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), CFG_T, "cpu")
    return jc, tc


def _assert_cache_equal(tc, jc):
    got = bridge.cache_to_numpy(tc)
    want = jax.tree.map(np.asarray, jc)
    for side in ("k", "v"):
        if isinstance(want[side], dict):
            for leaf in ("q", "s"):
                np.testing.assert_array_equal(got[side][leaf], want[side][leaf])
        else:
            np.testing.assert_array_equal(got[side], want[side])
    np.testing.assert_array_equal(got["length"], np.asarray(want["length"]))


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_inject_rows_and_extract_row_match_jax(kv_dtype):
    pool_j, pool_t = _caches(kv_dtype, 4, seed=1)
    rows_j, rows_t = _caches(kv_dtype, 3, seed=2)
    # Row 2 is a PAD row aliased to row 0's slot: the real row wins.
    slots = [3, 1, 3]
    pool_j = jb._inject_rows(pool_j, rows_j, jnp.asarray(slots, jnp.int32))
    pool_t = tb._inject_rows(pool_t, rows_t, slots)
    _assert_cache_equal(pool_t, pool_j)
    row_j = jb._extract_row(pool_j, jnp.asarray(3, jnp.int32))
    row_t = tb._extract_row(pool_t, 3)
    _assert_cache_equal(row_t, row_j)
    # One row back into another slot, through _inject_row.
    pool_j = jb._inject_row(pool_j, row_j, jnp.asarray(0, jnp.int32))
    pool_t = tb._inject_row(pool_t, row_t, 0)
    _assert_cache_equal(pool_t, pool_j)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_row_write_past_the_cache_end_is_dropped(kv_dtype):
    """kv_write_rows at positions 15 (last), 16 and 40 of a 16-position
    cache: the first lands, the others leave the cache as it was, as
    JAX's scatter drops them."""
    jc, tc = _caches(kv_dtype, 3, seed=4)
    rng = np.random.RandomState(5)
    new = rng.randn(3, 2, 8).astype(np.float32)
    pos = np.asarray([15, 16, 40])
    rows = np.arange(3)
    for side in ("k", "v"):  # one layer's (B, S, KV, HD) side
        layer_j = jax.tree.map(lambda a: a[0], jc[side])
        layer_j = jkv.kv_write_rows(layer_j, jnp.asarray(new), jnp.asarray(rows), jnp.asarray(pos))
        jc[side] = jax.tree.map(lambda a, l0: a.at[0].set(l0), jc[side], layer_j)
        tkv.kv_write_rows(
            tkv.kv_map(lambda a: a[0], tc[side]), torch.from_numpy(new),
            torch.from_numpy(rows), torch.from_numpy(pos),
        )
    _assert_cache_equal(tc, jc)
    row0 = tc["k"]["q"] if isinstance(tc["k"], dict) else tc["k"]
    assert row0[0, 0, 15].abs().sum() > 0  # the in-range write landed
