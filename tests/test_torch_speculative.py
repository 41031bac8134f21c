"""Speculative decoding: ``tpuslo_torch.models.speculative`` against the
JAX module.

Both sides run ``llama_tiny`` in f32 on the CPU over the same weights
(drawn by JAX from a seed, carried over as numpy).  One round
(``_spec_round_core``) is held to the JAX function on the same caches:
drafts, target picks and accepted counts equal, both caches' KV within
1e-4 up to the new frontier, lengths equal.  The engines are held to the
JAX ``SpeculativeEngine``: token streams, round counts and accepted
draft tokens identical, and each stream equal to the target-only greedy
stream, which is the module's guarantee.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo.models import speculative as jsp  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.models import speculative as tsp  # noqa: E402

KV_TOL = 1e-4
BUCKETS = (32, 64)
_SHARED: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny models gain nothing from intra-op threads, and several
    test workers on one machine lose a lot to them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(max_seq_len: int):
    return (
        dataclasses.replace(jl.llama_tiny(max_seq_len=max_seq_len), dtype=jnp.float32),
        dataclasses.replace(tl.llama_tiny(max_seq_len=max_seq_len), dtype=torch.float32),
    )


def _engines(max_seq_len: int = 128, draft_seed: int = 0):
    """(JAX target, JAX draft, port target, port draft) over the same
    weights, built once per (capacity, draft seed).  Draft seed 0 is the
    target's own weights: a self-draft."""
    key = (max_seq_len, draft_seed)
    if key not in _SHARED:
        cj, ct = _cfgs(max_seq_len)

        def pair(seed):
            pj = jl.init_params(jax.random.PRNGKey(seed), cj)
            pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), ct, "cpu")
            return (js.ServeEngine(cfg=cj, params=pj, prefill_buckets=BUCKETS),
                    ts.ServeEngine(cfg=ct, params=pt, prefill_buckets=BUCKETS, device="cpu"))

        tj, tt = pair(0)
        dj, dt = pair(draft_seed)
        _SHARED[key] = (tj, dj, tt, dt)
    return _SHARED[key]


def _greedy(engine, prompt, n, prefix=None):
    return [e.token_id for e in engine.generate(prompt, n, stop_at_eos=False, prefix=prefix)]


def _both(max_seq_len, draft_seed, k):
    tj, dj, tt, dt = _engines(max_seq_len, draft_seed)
    return jsp.SpeculativeEngine(tj, dj, k=k), tsp.SpeculativeEngine(tt, dt, k=k)


def _same_counts(sj, st):
    assert (st.rounds, st.accepted_draft_tokens, st.emitted_tokens) == (
        sj.rounds, sj.accepted_draft_tokens, sj.emitted_tokens)


# ---- one round against the JAX function ---------------------------------


def _round_inputs(rows, vector: bool):
    """Both frameworks' (params, current, caches, start) after
    prefilling ``rows`` on the target and the different draft."""
    tj, dj, tt, dt = _engines(128, 7)
    logits_j, cache_tj = tj._prefill_rows(rows, 0)
    _, cache_dj = dj._prefill_rows(rows, 0)
    current = np.asarray(jnp.argmax(logits_j, axis=-1))
    if not vector:
        scalar = jnp.asarray(len(rows[0]), jnp.int32)
        cache_tj = {**cache_tj, "length": scalar}
        cache_dj = {**cache_dj, "length": scalar}

    def carry(cache, cfg):
        out = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache), cfg, "cpu")
        if not vector:  # the port's device-side scalar frontier is 0-d
            out["length"] = torch.tensor(out["length"], dtype=torch.long)
        return out

    cache_tt, cache_dt = carry(cache_tj, tt.cfg), carry(cache_dj, dt.cfg)
    return ((tj, dj, jnp.asarray(current, jnp.int32), cache_tj, cache_dj),
            (tt, dt, torch.from_numpy(current.astype(np.int64)), cache_tt, cache_dt))


@pytest.mark.parametrize("vector,active", [
    (False, None), (True, None), (True, [True, False, True]),
], ids=["scalar", "vector", "vector-active"])
def test_round_core_matches_jax(vector, active):
    k = 3
    rows = ([[ts.BOS, 5, 6, 7, 8, 9], [ts.BOS, 11, 12], [ts.BOS, 21, 22, 23]] if vector
            else [[ts.BOS, 5, 6, 7], [ts.BOS, 9, 8, 7]])
    (tj, dj, cur_j, ctj, cdj), (tt, dt, cur_t, ctt, cdt) = _round_inputs(rows, vector)
    act_j = None if active is None else jnp.asarray(active)
    act_t = None if active is None else torch.tensor(active)
    for _ in range(2):  # the second round starts from the first's carries
        dr_j, pr_j, ac_j, cur_j, ctj, cdj = jsp._spec_round_core(
            tj.params, dj.params, cur_j, ctj, cdj, ctj["length"], act_j, k, tj.cfg, dj.cfg)
        reads = ts._HostRead.reads
        dr_t, pr_t, ac_t, cur_t, ctt, cdt = tsp._spec_round_core(
            tt.params, dt.params, cur_t, ctt, cdt, ctt["length"], act_t, k, tt.cfg, dt.cfg)
        assert ts._HostRead.reads == reads  # nothing read inside the round
        assert dr_t.tolist() == np.asarray(dr_j).tolist()
        assert pr_t.tolist() == np.asarray(pr_j).tolist()
        assert ac_t.tolist() == np.asarray(ac_j).tolist()
        assert cur_t.tolist() == np.asarray(cur_j).tolist()
        for ct, cj in ((ctt, ctj), (cdt, cdj)):
            assert isinstance(ct["length"], torch.Tensor)
            assert ct["length"].ndim == (1 if vector else 0)
            lengths = np.broadcast_to(np.asarray(cj["length"]), (len(rows),))
            assert np.broadcast_to(ct["length"].numpy(), (len(rows),)).tolist() == lengths.tolist()
            for side in ("k", "v"):
                got, want = ct[side].numpy(), np.asarray(cj[side])
                for b, n in enumerate(lengths):
                    np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], atol=KV_TOL, rtol=0)
    if active is not None:  # a frozen row keeps its frontier and token
        assert int(ctt["length"][1]) == len(rows[1])


def test_multi_round_equals_chained_single_rounds():
    """rounds=2 in one call == two batched rounds, on the port alone."""
    k = 3
    rows = [[ts.BOS, 5, 6, 7, 8, 9], [ts.BOS, 11, 12]]
    _, (tt, dt, cur, ct, cd) = _round_inputs(rows, True)
    _, (_, _, cur2, ct2, cd2) = _round_inputs(rows, True)
    active = torch.tensor([True, True])
    multi = tsp._shared_spec_multi_round_fn(tt.cfg, dt.cfg, k, 2)
    single = tsp._shared_spec_round_batch_fn(tt.cfg, dt.cfg, k)
    assert multi is tsp._shared_spec_multi_round_fn(tt.cfg, dt.cfg, k, 2)  # memoized
    dr, pr, ac, cur, ct, cd = multi(tt.params, dt.params, cur, ct, cd, ct["length"], active)
    assert dr.shape == (2, 2, k) and pr.shape == (2, 2, k + 1) and ac.shape == (2, 2)
    for r in range(2):
        d1, p1, a1, cur2, ct2, cd2 = single(
            tt.params, dt.params, cur2, ct2, cd2, ct2["length"], active)
        assert (dr[:, r].tolist(), pr[:, r].tolist(), ac[:, r].tolist()) == (
            d1.tolist(), p1.tolist(), a1.tolist())
    assert ct["length"].tolist() == ct2["length"].tolist() and cur.tolist() == cur2.tolist()


def test_verify_chunk_drops_positions_past_the_cache_end():
    """A frozen row within k of the end keeps verifying k+1 positions;
    the positions past the end write nothing (JAX drops the scatter) and
    the positions inside are written as ever."""
    tj, _, tt, _ = _engines(64, 0)
    S = tt.cfg.max_seq_len
    rows = torch.arange(2)
    new = torch.randn(2, 4, tt.cfg.n_kv_heads, tt.cfg.head_dim)
    from tpuslo_torch.models import kv_cache as tkv
    side = torch.zeros(2, S, tt.cfg.n_kv_heads, tt.cfg.head_dim)
    side[:, :4] = 7.0
    tkv.kv_write_rows_seq(side, new, rows, torch.tensor([S - 2, 10]))
    assert torch.equal(side[0, S - 2:], new[0, :2]) and torch.equal(side[1, 10:14], new[1])
    assert torch.all(side[:, :4] == 7.0)  # the wrapped indices kept their values
    chunk = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    cache = tl.init_kv_cache(tt.cfg, 2, device="cpu")
    logits, _ = tl.verify_chunk(tt.params, chunk, {**cache, "length": torch.tensor([S - 2, 3])}, tt.cfg)
    ref_cache = jl.init_kv_cache(tj.cfg, 2)
    ref, _ = jl.verify_chunk(tj.params, jnp.asarray(chunk.numpy(), jnp.int32),
                             {**ref_cache, "length": jnp.asarray([S - 2, 3], jnp.int32)}, tj.cfg)
    np.testing.assert_allclose(logits[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits[0, :2].numpy(), np.asarray(ref[0, :2]), atol=1e-4, rtol=0)


# ---- the engine against the JAX engine and target-only greedy ------------


@pytest.mark.parametrize("draft_seed", [0, 99], ids=["self-draft", "different-draft"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_stream_equals_jax_engine_and_target_only_greedy(k, draft_seed):
    sj, st = _both(128, draft_seed, k)
    want = _greedy(st.target, "speculate!", 24)
    reads = ts._HostRead.reads
    got = st.generate("speculate!", max_new_tokens=24, stop_at_eos=False)
    reads = ts._HostRead.reads - reads
    assert got == want
    assert got == sj.generate("speculate!", max_new_tokens=24, stop_at_eos=False)
    _same_counts(sj, st)
    assert reads == 1 + st.rounds  # the first token, then one read per round
    if draft_seed == 0:
        assert st.acceptance_rate > 0.9
    else:
        assert st.acceptance_rate < 1.0 and st.rounds > 0


def test_respects_max_new_tokens_and_rejects_bad_k():
    sj, st = _both(128, 0, 4)
    out = st.generate("bounded", max_new_tokens=7, stop_at_eos=False)
    assert len(out) == 7
    assert out == sj.generate("bounded", max_new_tokens=7, stop_at_eos=False)
    with pytest.raises(ValueError, match="k must be"):
        tsp.SpeculativeEngine(st.target, st.draft, k=0)


@pytest.mark.parametrize("prompt,n,draft_seed", [
    ("y" * 56, 32, 0),  # 57 ids: a 6-token budget under k+1 = 5 free slots
    ("y" * 60, 8, 7),  # 61 ids in a 64-slot cache: the single-step tail alone
], ids=["tail-after-rounds", "tail-only"])
def test_near_capacity_tail_matches_target_only(prompt, n, draft_seed):
    sj, st = _both(64, draft_seed, 4)
    want = _greedy(st.target, prompt, n)
    assert len(want) == st.target.decode_cap_tokens(len(prompt) + 1) or len(want) == n
    got = st.generate(prompt, max_new_tokens=n, stop_at_eos=False)
    assert got == want
    assert got == sj.generate(prompt, max_new_tokens=n, stop_at_eos=False)
    _same_counts(sj, st)


def test_long_prompt_chunked_ingestion():
    sj, st = _both(256, 7, 3)
    prompt = "z" * 150  # 151 ids, past the largest bucket (64)
    got = st.generate(prompt, max_new_tokens=16, stop_at_eos=False)
    assert got == _greedy(st.target, prompt, 16)
    assert got == sj.generate(prompt, max_new_tokens=16, stop_at_eos=False)
    _same_counts(sj, st)


def test_stream_yields_first_token_before_the_rest():
    _, st = _both(128, 0, 3)
    gen = st.stream("stream me", max_new_tokens=64, stop_at_eos=False)
    first = next(gen)
    assert isinstance(first, int)
    assert st.emitted_tokens == 1 and st.rounds == 0  # nothing decoded past the prefill
    assert [first] + list(gen) == _greedy(st.target, "stream me", 64)


def test_stream_stops_at_eos_like_jax():
    sj, st = _both(128, 0, 3)
    for i in range(3):
        got = st.generate(f"eos probe {i}", max_new_tokens=16)
        assert got == sj.generate(f"eos probe {i}", max_new_tokens=16)
        assert ts.EOS not in got[:-1]


def test_prefix_stream_matches_target_prefix_stream():
    sj, st = _both(128, 7, 3)
    prefix = "shared system preamble for speculation"
    got = st.generate("user ask", max_new_tokens=10, stop_at_eos=False, prefix=prefix)
    assert got == _greedy(st.target, "user ask", 10, prefix=prefix)
    assert got == sj.generate("user ask", max_new_tokens=10, stop_at_eos=False, prefix=prefix)
    _same_counts(sj, st)


def test_joint_prompt_ids_equal_jax():
    tj, dj, tt, dt = _engines(128, 7)
    for prompt, prefix in (("plain", None), ("q" * 400, None), ("ask", "pre " * 10),
                           ("ask" * 80, "pre " * 20)):
        assert tsp.joint_prompt_ids(tt, dt, prompt, prefix) == tuple(
            jsp.joint_prompt_ids(tj, dj, prompt, prefix))


class TestBatched:
    """generate_batch: per-row streams identical to the JAX engine's and
    to target-only greedy, with per-row acceptance divergence riding the
    vector-length verify."""

    def _hold(self, draft_seed, k, prompts, n, prefix=None):
        sj, st = _both(128, draft_seed, k)
        calls = []
        for name in ("_round_batch", "_target_step"):
            def counted(*args, _fn=getattr(st, name), _name=name):
                calls.append(_name)
                return _fn(*args)
            setattr(st, name, counted)
        reads = ts._HostRead.reads
        batch = st.generate_batch(prompts, max_new_tokens=n, stop_at_eos=False, prefix=prefix)
        # One read for the first tokens, then one per batched round and
        # one per tail step: nothing else reaches the host.
        assert ts._HostRead.reads - reads == 1 + len(calls)
        assert "_round_batch" in calls
        assert batch == sj.generate_batch(prompts, max_new_tokens=n, stop_at_eos=False,
                                          prefix=prefix)
        _same_counts(sj, st)
        for prompt, row in zip(prompts, batch):
            assert row == _greedy(st.target, prompt, n, prefix=prefix), prompt
        return st, batch

    def test_rows_match_with_a_weak_draft(self):
        st, _ = self._hold(7, 3, ["first spec row", "a different second row",
                                     "and a third one"], 10)
        assert st.acceptance_rate < 1.0

    def test_rows_match_single_row_speculative(self):
        prompts = ["row with its own pace", "short"]
        st, batch = self._hold(7, 3, prompts, 8)
        single = tsp.SpeculativeEngine(st.target, st.draft, k=3)
        for prompt, row in zip(prompts, batch):
            assert row == single.generate(prompt, max_new_tokens=8, stop_at_eos=False)

    def test_self_draft_accepts_nearly_everything(self):
        st, batch = self._hold(0, 4, ["same model drafts", "twice"], 12)
        assert all(len(r) == 12 for r in batch)
        assert st.acceptance_rate > 0.9

    def test_heterogeneous_lengths_near_capacity_no_truncation(self):
        self._hold(0, 4, ["x" * 99, "short row"], 24)

    def test_pads_to_buckets_and_returns_real_rows(self):
        _, batch = self._hold(7, 2, ["one", "two", "three"], 5)
        assert len(batch) == 3

    def test_prefix_rows_match_target_prefix_streams(self):
        self._hold(7, 3, ["first ask", "second ask"], 8, prefix="shared batched preamble")

    def test_oversized_batch_splits_and_empty_batch(self):
        sj, st = _both(128, 7, 3)
        prompts = [f"p{i}" for i in range(3)]
        got = st.generate_batch(prompts, max_new_tokens=4, stop_at_eos=False, batch_buckets=(1, 2))
        assert got == sj.generate_batch(prompts, max_new_tokens=4, stop_at_eos=False,
                                        batch_buckets=(1, 2))
        assert st.generate_batch([]) == []


def test_engines_take_their_device_from_their_serve_engines_and_refuse_a_mesh():
    _, _, tt, dt = _engines(128, 7)
    assert tsp.SpeculativeEngine(tt, dt).device == tt.device
    assert tsp._rehome_draft_cache(tt, dt, {"k": 1}) == {"k": 1}

    # A draft sharded over another mesh than the target's is refused (an
    # unsharded draft is replicated on every tp rank: its cache stays home).
    class Meshed:
        device = tt.device
        mesh = object()

    with pytest.raises(ValueError, match="share the target's mesh"):
        tsp._check_pair(tt, Meshed())


def _state_storage(spec) -> dict:
    """data_ptr() of every buffer of every dispatch shape the engine has
    built: both caches' leaves, ``current``, the frontier or the staged
    frontiers and mask."""
    ptrs = {}
    for batch, st in spec._states.items():
        for name, cache in (("t", st.cache_t), ("d", st.cache_d)):
            for side in ("k", "v"):
                ptrs[(batch, name, side)] = cache[side].data_ptr()
        ptrs[(batch, "current")] = st.current.data_ptr()
        if batch is None:
            ptrs[(batch, "frontier")] = st.frontier.data_ptr()
            assert st.cache_t["length"] is st.frontier is st.cache_d["length"]
        else:
            ptrs[(batch, "start")] = st.start.tensor.data_ptr()
            ptrs[(batch, "active")] = st.active.tensor.data_ptr()
    return ptrs


def test_streams_and_batches_reuse_the_engines_storage():
    """Every stream copies its freshly ingested caches into the engine's
    one pair of single-row caches, and every batch of a bucket into that
    bucket's: the buffers a round's graph reads never move, from the
    first request to the last, near capacity too (the eager tail runs on
    the same caches); the streams stay the target-only greedy streams."""
    _, _, tt, dt = _engines(128, 7)
    spec = tsp.SpeculativeEngine(tt, dt, k=3)
    first = spec.generate("the first stream", max_new_tokens=9, stop_at_eos=False)
    batch = spec.generate_batch(["row one", "row two", "row three"], max_new_tokens=7,
                                stop_at_eos=False)
    fixed = _state_storage(spec)
    assert set(k[0] for k in fixed) == {None, 4}
    again = spec.generate("the first stream", max_new_tokens=9, stop_at_eos=False)
    tail = spec.generate("q" * 110, max_new_tokens=12, stop_at_eos=False)
    batch_again = spec.generate_batch(["row one", "row two", "row three"], max_new_tokens=7,
                                      stop_at_eos=False)
    assert _state_storage(spec) == fixed
    assert first == again == _greedy(tt, "the first stream", 9)
    assert tail == _greedy(tt, "q" * 110, 12)
    assert batch == batch_again
    for prompt, row in zip(["row one", "row two", "row three"], batch):
        assert row == _greedy(tt, prompt, 7)


def test_engines_and_their_dispatches_form_no_reference_cycle():
    """A dropped engine is freed by reference counting alone: its
    dispatches hold their bodies weakly, so the cyclic collector never has
    to free an engine (and, on a card, its graph) at an arbitrary moment,
    such as in the middle of another engine's capture."""
    import gc
    import weakref

    from tpuslo_torch.models import frontdoor as tfd

    _, _, tt, dt = _engines(128, 7)
    collecting = gc.isenabled()
    gc.disable()
    try:
        fd = tfd.FrontDoorEngine(tt, dt, k=3, max_slots=2)
        fd.submit("freed promptly", max_new_tokens=6, stop_at_eos=False)
        fd.run()
        spec = tsp.SpeculativeEngine(tt, dt, k=3)
        spec.generate("freed promptly", max_new_tokens=6, stop_at_eos=False)
        spec.generate_batch(["a", "bb"], max_new_tokens=6, stop_at_eos=False)
        refs = [weakref.ref(fd), weakref.ref(spec), weakref.ref(spec._states[None])]
        del fd, spec
        assert [r() for r in refs] == [None, None, None]
    finally:
        if collecting:
            gc.enable()
