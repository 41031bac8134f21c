"""ServeEngine parity: ``tpuslo_torch.models.serve`` against the JAX engine.

Both engines serve the same JAX-initialised weights (carried over as
numpy) in f32 on the CPU.  Greedy streams must be identical; a token
divergence is accepted only at a genuine tie, by the rule
``stream_parity`` uses: the JAX top-2 margin at that position is under
twice the logit tolerance (1e-4).  Sampled streams are held to JAX's
kept set of top-k/top-p at every position, since ``torch.Generator``
cannot reproduce ``jax.random`` draws.
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
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402

LOGIT_TOL = 1e-4
CHUNK = 8
CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=512), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=512), dtype=torch.float32)
SYSTEM = "You are the incident assistant of the serving team. Be brief. "

_ENGINES: dict = {}


def _engines(quantized: bool = False):
    """(JAX engine, port engine) over the same weights, built once."""
    if quantized not in _ENGINES:
        init = jl.init_params_quantized if quantized else jl.init_params
        pj = init(jax.random.PRNGKey(0), CFG_J)
        pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
        kv = "int8" if quantized else "bf16"
        _ENGINES[quantized] = (
            js.ServeEngine(CFG_J, pj, decode_chunk_size=CHUNK, kv_dtype=kv),
            ts.ServeEngine(CFG_T, pt, decode_chunk_size=CHUNK, kv_dtype=kv, device="cpu"),
        )
    return _ENGINES[quantized]


def _jax_logits_after(ej, ids: list[int]) -> np.ndarray:
    """JAX next-token logits after teacher-forcing ``ids`` (any length)."""
    logits, _ = ej.ingest_ids(list(ids))
    return np.asarray(logits[0], np.float32)


def _assert_same_stream(ej, ids, want: list[int], got: list[int]):
    """Identical, or diverging only where JAX's top-2 margin is a tie."""
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(want, got)):
        if a != b:
            top2 = np.sort(_jax_logits_after(ej, ids + want[:k]))[-2:]
            assert top2[1] - top2[0] < 2 * LOGIT_TOL, (k, want, got)
            return


CASES = {
    "short": ("hello world", None),
    "past_largest_bucket": ("x" * 300, None),
    "prefix": ("what broke first?", SYSTEM),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_greedy_matches_jax(case):
    ej, et = _engines()
    prompt, prefix = CASES[case]
    want = [e.token_id for e in ej.generate(prompt, 24, stop_at_eos=False, prefix=prefix)]
    events = list(et.generate(prompt, 24, stop_at_eos=False, prefix=prefix))
    got = [e.token_id for e in events]
    assert [e.index for e in events] == list(range(24))
    assert events[0].ttft_ms is not None and events[0].ttft_ms > 0
    if prefix:
        p_ids, s_ids = ts.prefix_prompt_ids(prefix, prompt, CFG_T.max_seq_len)
        ids = p_ids + s_ids
    else:
        ids = ts.encode_bytes(prompt, et.generation_prompt_cap())
    _assert_same_stream(ej, ids, want, got)


@pytest.mark.parametrize("prefix", [None, SYSTEM], ids=["plain", "prefix"])
def test_generate_batch_matches_jax(prefix):
    """Mixed lengths (one past the largest bucket: lockstep chunked
    prefill), five rows padded to the batch bucket of 8."""
    ej, et = _engines()
    prompts = ["a", "why is ttft high", "b" * 40, "c" * 270, "d" * 7]
    want = ej.generate_batch(prompts, 12, stop_at_eos=False, prefix=prefix)
    got = et.generate_batch(prompts, 12, stop_at_eos=False, prefix=prefix)
    for p, w, g in zip(prompts, want, got):
        if prefix:
            p_ids, _ = ts.prefix_prompt_ids(prefix, "", CFG_T.max_seq_len)
            ids = p_ids + list(p.encode())
        else:
            ids = ts.encode_bytes(p, et.generation_prompt_cap())
        _assert_same_stream(ej, ids, w, g)


def test_generate_batch_sub_batch_split():
    """A request larger than the largest batch bucket splits into
    sub-batches that serve each row as a full batch would."""
    _, et = _engines()
    prompts = ["one", "two two", "three three three"]
    split = et.generate_batch(prompts, 6, stop_at_eos=False, batch_buckets=(1, 2))
    whole = et.generate_batch(prompts, 6, stop_at_eos=False)
    assert [len(r) for r in split] == [6, 6, 6]
    assert split == whole


def test_forced_logits_match_jax():
    ej, et = _engines()
    ids = ts.encode_bytes("teacher forced context", 64)
    want = np.asarray(js.forced_logits(ej, ids))
    got = ts.forced_logits(et, ids)
    assert got.dtype == torch.float32 and tuple(got.shape) == (CFG_T.vocab_size,)
    assert np.abs(want - got.numpy()).max() < LOGIT_TOL
    with pytest.raises(ValueError, match="largest"):
        ts.forced_logits(et, [1] * 300)


def test_quantized_weights_int8_kv_match_jax():
    ej, et = _engines(quantized=True)
    assert et.quantized and et.kv_dtype == "int8"
    prompt = "int8 everything"
    want = [e.token_id for e in ej.generate(prompt, 16, stop_at_eos=False)]
    got = [e.token_id for e in et.generate(prompt, 16, stop_at_eos=False)]
    _assert_same_stream(ej, ts.encode_bytes(prompt, 510), want, got)


def _jax_kept(logits: np.ndarray, sampling, monkeypatch) -> np.ndarray:
    seen = {}

    def capture(key, filtered, axis=-1):
        seen["logits"] = np.asarray(filtered)
        return jnp.zeros(filtered.shape[:-1], jnp.int32)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", capture)
        jl.sample_from_logits(
            jnp.asarray(logits[None]), jax.random.PRNGKey(0),
            jl.SamplingConfig(sampling.temperature, sampling.top_k, sampling.top_p),
        )
    return np.isfinite(seen["logits"][0])


def test_sampled_generate_stays_in_jax_kept_set(monkeypatch):
    ej, et = _engines()
    sampling = tl.SamplingConfig(temperature=0.9, top_k=20, top_p=0.9)
    prompt = "sample me"
    got = [e.token_id for e in et.generate(prompt, 12, stop_at_eos=False,
                                           sampling=sampling, seed=3)]
    again = [e.token_id for e in et.generate(prompt, 12, stop_at_eos=False,
                                             sampling=sampling, seed=3)]
    assert got == again  # reproducible by seed
    ids = ts.encode_bytes(prompt, et.generation_prompt_cap())
    for k, tok in enumerate(got):
        kept = _jax_kept(_jax_logits_after(ej, ids + got[:k]), sampling, monkeypatch)
        assert kept[tok], (k, tok)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.ServeEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_params(0, tl.llama_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_kv_cache(tl.llama_tiny(), 1)
    engine = ts.ServeEngine(device="cpu")
    assert engine.device.type == "cpu"
    assert engine.params["embed"].device.type == "cpu"


def test_out_of_scope_paths_raise():
    """A serving mesh without a tp axis raises JAX's ``ValueError`` (tp
    serving itself: ``test_torch_tp_serve.py``); sequence-parallel
    ingestion refuses, with JAX's message, an engine with a mesh, int8 KV
    or int8 weights (the handoff itself: ``test_torch_sp_serve.py``)."""
    from tpuslo_torch.parallel import mesh as tmesh

    _, et = _engines()
    no_tp = tmesh.Mesh(tmesh.MeshPlan(), torch.device("cpu"), backend="gloo")
    no_tp.axis_names = ("dp",)
    with pytest.raises(ValueError, match="must have a 'tp' axis"):
        ts.ServeEngine(CFG_T, mesh=no_tp, device="cpu")
    sp = tmesh.sp_mesh(1, devices=["cpu"])
    for engine in (_engines(quantized=True)[1],  # int8 weights and int8 KV
                   ts.ServeEngine(CFG_T, et.params, kv_dtype="int8", device="cpu"),
                   ts.ServeEngine(CFG_T, et.params, mesh=tmesh.tp_mesh(1, devices=["cpu"]),
                                  device="cpu")):
        with pytest.raises(ValueError, match="single-device bf16"):
            engine.ingest_prompt_sp("x", sp)


def test_params_on_another_device_raise():
    meta = tl.init_params(0, tl.llama_tiny(), "cpu")
    meta["embed"] = meta["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on meta"):
        ts.ServeEngine(tl.llama_tiny(), meta, device="cpu")


@pytest.mark.parametrize("text", ["", "héllo", "x" * 600])
def test_tokenizer_and_truncation_match_jax(text):
    assert ts.encode_bytes(text, 510) == js.encode_bytes(text, 510)
    ids = ts.encode_bytes(text, 510)
    assert ts.decode_bytes(ids) == js.decode_bytes(ids)
    assert ts.prefix_prompt_ids(SYSTEM, text, 512) == js.prefix_prompt_ids(SYSTEM, text, 512)
    for n in (1, 32, 33, 256, 300):
        assert ts._bucket(n, (32, 64, 128, 256)) == js._bucket(n, (32, 64, 128, 256))


@pytest.mark.parametrize("longest", [1, 100, 480, 503, 505, 510])
def test_decode_budget_matches_jax(longest):
    ej, et = _engines()
    assert et.decode_cap_tokens(longest) == ej.decode_cap_tokens(longest)
    chunk, cap = et._decode_budget(longest)
    _fn, j_chunk, j_cap = ej._decode_budget(longest)
    assert (chunk, cap) == (j_chunk, j_cap)
    assert et._chunk_bucket(200, 512 - longest) == ej._chunk_bucket(200, 512 - longest)


def test_one_host_read_per_decode_chunk(monkeypatch):
    reads = []

    class CountingRead(ts._HostRead):
        def __init__(self, t):
            reads.append(tuple(t.shape))
            super().__init__(t)

    monkeypatch.setattr(ts, "_HostRead", CountingRead)
    _, et = _engines()
    events = list(et.generate("count my reads", 24, stop_at_eos=False))
    assert len(events) == 24
    # 23 tokens after the prefill token, 8 per chunk: three chunk reads.
    assert reads == [(CHUNK,)] * 3


def test_prefix_cache_is_a_fifo_of_four():
    _, et = _engines()
    et._prefix_cache.clear()
    texts = [f"prefix number {i}. " for i in range(5)]
    for text in texts:
        et.cache_prefix(text)
    assert not et.prefix_warm(texts[0])
    assert all(et.prefix_warm(t) for t in texts[1:])
    entry = et.cache_prefix(texts[4])
    before = entry.cache["k"].clone()
    list(et.generate("suffix", 4, stop_at_eos=False, prefix=texts[4]))
    assert torch.equal(entry.cache["k"], before)  # the snapshot is never written


def test_record_compile_counts_first_hits_only():
    _, et = _engines()
    et.compile_events.clear()
    et._seen_shapes.discard(("prefill", 999))
    et._record_compile("prefill", 999, 150.0)
    et._record_compile("prefill", 999, 150.0)
    et._record_compile("suffix", 998, 50.0)
    assert et.compile_events == [{"bucket": 999, "compile_ms": 150.0}]


def test_stream_parity_of_two_port_engines():
    _, et = _engines()
    twin = ts.ServeEngine(CFG_T, et.params, decode_chunk_size=CHUNK, device="cpu")
    report = ts.stream_parity(twin, et, "parity", max_new_tokens=4)
    assert report["ok"] and report["tokens_candidate"] == report["tokens_reference"]
    assert report["max_logit_diff"] == 0.0


def test_warmup_runs():
    _, et = _engines()
    assert et.warmup() > 0.0


# ---- admissions through staged storage (the front door's path) --------------


def _admission_engine():
    """The port engine with its admission pieces for batches of 1-8 rows
    (on the CPU every piece runs its eager body over staged storage)."""
    _ej, et = _engines()
    return et, et.admission_graphs((1, 2, 4, 8))


def _ids(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [ts.BOS] + rng.integers(0, 256, n - 1).tolist()


def _same_rows(got: dict, want: dict, lengths) -> None:
    for side in ("k", "v"):
        for b, n in enumerate(lengths):
            assert torch.equal(got[side][:, b, :n], want[side][:, b, :n]), (side, b)


def test_suffix_prefill_start_as_a_device_scalar_equals_an_int():
    """One chunk appended at a 0-d tensor start (positions and cache
    writes computed on the device) gives the int start's bits."""
    _ej, et = _engines()
    _, cache = et.prefill_ids(_ids(1, 40))
    tokens = torch.tensor([_ids(2, 32)[1:] + [0]], dtype=torch.long)
    a = et._clone_cache(cache)
    b = et._clone_cache(cache)
    la, ca = ts.suffix_prefill(et.params, tokens, a, 40, 25, CFG_T)
    lb, cb = ts.suffix_prefill(et.params, tokens, b, torch.tensor(40), torch.tensor([25]),
                               CFG_T)
    assert torch.equal(la, lb)
    assert ca["length"] == 65 and cb["length"].tolist() == [65]
    for side in ("k", "v"):
        assert torch.equal(ca[side], cb[side])


@pytest.mark.parametrize("lengths", [[9], [30, 3], [64, 40, 33, 50],
                                     [200, 17, 5, 128, 64, 3, 100, 90], [450, 40, 300, 9]],
                         ids=["one", "two", "four", "eight", "long"])
def test_admission_prefill_rows_equal_the_eager_path(lengths):
    """A cold batched admission (pad rows of the batch bucket included)
    through the pieces gives ``_prefill_rows``' logits, lengths and row
    K/V bit for bit; a row past the largest bucket runs its chunks alone
    on the staged row, the rows that ended before no pad chunks."""
    et, adm = _admission_engine()
    B = ts._bucket(len(lengths), adm.batch_buckets)
    rows = [_ids(10 + i, n) for i, n in enumerate(lengths)] + [[ts.BOS]] * (B - len(lengths))
    want_logits, want = et._prefill_rows(rows, 0)
    eager = adm.eager_chunks
    got_logits, got = adm.prefill_rows(rows)
    assert torch.equal(got_logits, want_logits)
    assert torch.equal(got["length"], want["length"])
    _same_rows(got, want, [len(r) for r in rows])
    assert adm.eager_chunks == eager


def test_admission_ingestion_equals_the_eager_path():
    """A single cold prompt past the largest bucket, warm prefix tails at
    each suffix bucket and none, and a snapshot-restored context: the
    pieces give ``ingest_ids``' logits, length and row K/V bit for bit,
    and the warm rows are copies in staged storage, never the snapshot."""
    et, adm = _admission_engine()
    prefix = SYSTEM
    prefix_ids, _ = ts.prefix_prompt_ids(prefix, "", CFG_T.max_seq_len)
    cases = [(_ids(3, 300), None, None), (_ids(4, 70), None, None)]
    cases += [(prefix_ids + _ids(S, S + 1)[1:], prefix, prefix_ids) for S in (20, 64, 128, 256)]
    cases += [(list(prefix_ids), prefix, prefix_ids)]
    for ids, pre, pre_ids in cases:
        want_logits, want = et.ingest_ids(ids, pre, pre_ids)
        got_logits, got = adm.ingest_ids(ids, pre, pre_ids)
        assert torch.equal(got_logits, want_logits), len(ids)
        assert got["length"] == want["length"] == len(ids)
        _same_rows(got, want, [len(ids)])
        assert got["k"].data_ptr() == adm.row["k"].data_ptr()
    assert adm.eager_chunks == 0


def test_an_admission_chunk_no_bucket_fits_runs_eagerly_and_is_counted():
    """A warm prefix's tail that ends in the cache's last 31 positions
    leaves a chunk no prefill bucket fits: it runs eagerly, is counted,
    and the result still equals the eager path's."""
    et, adm = _admission_engine()
    prefix = "Be brief. "
    prefix_ids, _ = ts.prefix_prompt_ids(prefix, "", CFG_T.max_seq_len)
    start = len(prefix_ids)
    odd = next(n for n in range(1, CFG_T.max_seq_len - 1 - start)
               if any(b not in et.prefill_buckets for _, _, b in et._schedule(n, start)))
    ids = prefix_ids + _ids(7, odd + 1)[1:]
    want_logits, want = et.ingest_ids(ids, prefix, prefix_ids)
    eager = adm.eager_chunks
    got_logits, got = adm.ingest_ids(ids, prefix, prefix_ids)
    assert adm.eager_chunks == eager + 1
    assert torch.equal(got_logits, want_logits)
    _same_rows(got, want, [len(ids)])


def test_a_prefix_entry_kept_across_two_admissions_is_unchanged():
    """A prefix snapshot made by an admission is a copy of staged storage:
    later admissions, which rewrite that storage, leave it bit for bit."""
    et, _adm = _admission_engine()
    text = "A prefix cached while admitting. "
    entry = et.cache_prefix(text, ingest=_adm.ingest)
    kept = [entry.cache["k"].clone(), entry.cache["v"].clone(), entry.logits.clone()]
    _adm.prefill_rows([_ids(5, 80), _ids(6, 40)])
    _adm.ingest_ids(_ids(8, 300))
    assert entry.cache["k"].data_ptr() != _adm.row["k"].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [entry.cache["k"], entry.cache["v"], entry.logits]))
    # ... and it equals the snapshot the eager path makes.
    _, ej = None, ts.ServeEngine(CFG_T, et.params, decode_chunk_size=CHUNK, device="cpu")
    eager = ej.cache_prefix(text)
    assert torch.equal(eager.logits, entry.logits) and eager.ids == entry.ids
    _same_rows(entry.cache, eager.cache, [len(entry.ids)])


def test_staged_input_takes_several_writes_before_a_read():
    from tpuslo_torch.models.graphs import StagedInput

    staged = StagedInput((2,), torch.long, torch.device("cpu"))
    seen = []
    for values in ([1, 2], np.asarray([3, 4]), [5, 6]):
        staged.write(values)
        seen.append(staged.tensor.clone())
    assert [t.tolist() for t in seen] == [[1, 2], [3, 4], [5, 6]]
    scalar = StagedInput((), torch.long, torch.device("cpu"))
    scalar.write(7)
    assert scalar.tensor.item() == 7
