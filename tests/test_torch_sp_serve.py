"""The sequence-parallel prefill handoff (``tpuslo_torch.models.sp_serve``
and ``ServeEngine.ingest_prompt_sp``) against ``tpuslo.models.sp_serve``:
a counterpart of each test in ``tests/test_sp_serve.py``, with JAX's f32
GQA config (4 heads over 2 kv heads) and its 1e-3, the port over gloo
ranks on the CPU (one group per world size,
``test_torch_sp_ranks.sp_serve_checks``) and JAX over a CPU mesh of as
many devices, on the same weights carried over by the bridge.

* sp 4 prefill logits and KV against the dense prefill, a padded prompt
  whose last real position lives on an interior rank, and the two-rank
  axis, each also against JAX's ``sp_prefill``;
* the handoff into a dense cache, then four ``decode_step``s against the
  dense path, and against JAX's ``sp_prefill_into_cache``;
* ``ingest_prompt_sp`` against ``ingest_prompt`` (logits, length, three
  decode steps, and ``generate``'s ordinary loop from the installed
  cache), and against JAX's engine;
* the refusals with JAX's messages: a misaligned length, an out-of-range
  ``true_length``, an engine with a mesh, int8 KV or int8 weights, a
  prompt no sp-aligned cache holds.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_sp_ranks as ranks  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo.models import sp_serve as jsp  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.models import sp_serve as tsp  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

TOL = 1e-3
PROMPT = "long sequence-parallel prompt " * 3  # 91 ids > one bucket


def _cfg_j(max_seq_len: int = 64) -> jl.LlamaConfig:
    return jl.LlamaConfig(vocab_size=256, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=64, max_seq_len=max_seq_len, rope_theta=10000.0,
                          dtype=jnp.float32)


CFG_J = _cfg_j()
CFG_T = ranks._f32_gqa()


def _mesh(n: int = 4) -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:n]), ("sp",))


def _fake_mesh(sp: int = 4):
    """A mesh of ``sp`` ranks with no group: the refusals raise before any
    collective."""
    return tmesh.Mesh(None, torch.device("cpu"), backend="gloo", axes=(("sp",), (sp,)))


def _randint(seed: int, shape) -> np.ndarray:
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 255))


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(0), CFG_J)


@pytest.fixture(scope="module")
def params(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG_T, "cpu")


@pytest.fixture(scope="module")
def inputs():
    padded = np.pad(_randint(2, (1, 17)), ((0, 0), (0, 32 - 17)))
    return {"dense": _randint(1, (2, 32)), "padded": padded, "true_length": 17,
            "handoff": _randint(3, (1, 32)), "prompt": PROMPT, "two_axis": _randint(4, (1, 48))}


@pytest.fixture(scope="module")
def groups(jparams, inputs):
    """One group of ranks per world size, run at its first use."""
    ran: dict = {}

    def get(world: int):
        if world not in ran:
            ran[world] = tmesh.run_ranks(
                ranks.sp_serve_checks, world, timeout_s=ranks.RANK_TIMEOUT_S,
                args=(jax.tree.map(np.asarray, jparams), inputs))
        return ran[world]

    return get


def _dense(params, tokens: np.ndarray, true_length=None):
    return tl.prefill(params, torch.from_numpy(tokens).long(),
                      tl.init_kv_cache(CFG_T, tokens.shape[0], device="cpu"), CFG_T,
                      true_length=true_length)


def test_sp_prefill_matches_dense_logits_and_kv(groups, jparams, params, inputs):
    S = 32
    logits, cache = _dense(params, inputs["dense"])
    jlogits, jks, jvs = jsp.sp_prefill(jparams, jnp.asarray(inputs["dense"]), CFG_J, _mesh())
    for r in groups(4):
        got = r["dense"]
        assert _max_err(got["logits"], logits) < TOL
        assert _max_err(got["ks"], cache["k"][:, :, :S]) < TOL
        assert _max_err(got["vs"], cache["v"][:, :, :S]) < TOL
        assert _max_err(got["logits"], jlogits) < TOL
        assert _max_err(got["ks"], jks) < TOL and _max_err(got["vs"], jvs) < TOL


def test_sp_prefill_padded_prompt_true_length(groups, jparams, params, inputs):
    """Padded to an sp-aligned length: the last real position's logits
    come back though it sits on an interior rank (16 of 4 x 8)."""
    true = inputs["true_length"]
    logits, _ = _dense(params, inputs["padded"], true_length=true)
    jlogits, _, _ = jsp.sp_prefill(jparams, jnp.asarray(inputs["padded"]), CFG_J, _mesh(),
                                   true_length=jnp.asarray(true, jnp.int32))
    for r in groups(4):
        assert _max_err(r["padded"], logits) < TOL
        assert _max_err(r["padded"], jlogits) < TOL


def test_sp_prefill_rejects_misaligned_length(params):
    with pytest.raises(ValueError, match="not divisible"):
        tsp.sp_prefill(params, torch.zeros((1, 30), dtype=torch.long), CFG_T, _fake_mesh())


@pytest.mark.parametrize("bad", [0, 33])
def test_sp_prefill_rejects_out_of_range_true_length(params, bad):
    """An out-of-range true_length would sum a zero hidden state into
    plausible-looking logits; the API refuses instead."""
    with pytest.raises(ValueError, match="outside"):
        tsp.sp_prefill(params, torch.zeros((1, 32), dtype=torch.long), CFG_T, _fake_mesh(),
                       true_length=bad)


def test_sp_prefill_into_cache_then_decode_matches_dense(groups, jparams, params, inputs):
    """The handoff: split prefill -> dense cache -> the ordinary
    decode_step continues within 1e-3 of the all-dense path."""
    logits, _ = _dense(params, inputs["handoff"])
    jlogits, jcache = jsp.sp_prefill_into_cache(jparams, jnp.asarray(inputs["handoff"]),
                                                jl.init_kv_cache(CFG_J, 1), CFG_J, _mesh())
    for r in groups(4):
        got = r["handoff"]
        assert got["length"] == 32
        same = int(np.argmax(got["logits"])) == int(logits.argmax())
        top2 = np.sort(logits[0].numpy())[-2:]
        assert same or top2[1] - top2[0] < 0.15
        assert _max_err(got["logits"], jlogits) < TOL
        assert _max_err(got["k"], jcache["k"]) < TOL
        for dense_step, sp_step in got["steps"]:
            assert _max_err(dense_step, sp_step) < TOL


def test_engine_ingest_prompt_sp_matches_dense_ingest(groups, jparams, inputs):
    """A long prompt ingested over the sp mesh gives the logits and length
    of the chunked single-device path, and the ordinary decode loop
    (``decode_step``, ``generate``) continues from the installed cache."""
    jengine = js.ServeEngine(cfg=_cfg_j(128), params=jparams, prefill_buckets=(32,))
    jlogits, _, jlen = jengine.ingest_prompt_sp(PROMPT, _mesh())
    for r in groups(4):
        got = r["engine"]
        assert got["s_len"] == got["d_len"] == jlen == 91
        assert _max_err(got["s_logits"], got["d_logits"]) < TOL
        assert _max_err(got["s_logits"], jlogits) < TOL
        for dense_step, sp_step in got["steps"]:
            assert _max_err(dense_step, sp_step) < TOL
        assert got["generate_sp"] == got["generate"]


def test_engine_ingest_prompt_sp_makes_one_ring_and_one_gather(groups):
    """One prefill over the ring (k and v shifted 3 times a layer at sp 4),
    the last row's sum, and one all_gather per cache side."""
    for r in groups(4):
        assert r["engine"]["calls"] == {"shift": 2 * 3 * CFG_T.n_layers, "all_reduce": 1,
                                        "all_gather": 2}


@pytest.mark.parametrize("engine_kw", [{"kv_dtype": "int8"}, {"quantize": True}, "mesh"],
                         ids=["int8_kv", "int8_weights", "tp_mesh"])
def test_engine_ingest_prompt_sp_guards(params, engine_kw):
    if engine_kw == "mesh":
        engine_kw = {"mesh": tmesh.tp_mesh(1, devices=["cpu"])}
    engine = ts.ServeEngine(_cfg_t(64), params=params if "quantize" not in engine_kw else None,
                            prefill_buckets=(32,), device="cpu", **engine_kw)
    with pytest.raises(ValueError, match="single-device bf16"):
        engine.ingest_prompt_sp("p", _fake_mesh())


def _cfg_t(max_seq_len: int):
    return ranks._f32_gqa(max_seq_len=max_seq_len)


def test_engine_ingest_prompt_sp_refuses_a_prompt_no_aligned_cache_holds(params):
    """max_seq_len 67: the aligned capacity is 64, but encode_bytes caps the
    prompt at 65 ids."""
    engine = ts.ServeEngine(_cfg_t(67), params=params, prefill_buckets=(32,), device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        engine.ingest_prompt_sp("x" * 70, _fake_mesh())
    jengine = js.ServeEngine(cfg=_cfg_j(67), params=None, prefill_buckets=(32,))
    with pytest.raises(ValueError, match="cannot hold"):
        jengine.ingest_prompt_sp("x" * 70, _mesh())


def test_sp_prefill_two_device_axis(groups, jparams, params, inputs):
    """An axis of 2 (another number of ring rotations)."""
    logits, _ = _dense(params, inputs["two_axis"])
    jlogits, _, _ = jsp.sp_prefill(jparams, jnp.asarray(inputs["two_axis"]), CFG_J, _mesh(2))
    for r in groups(2):
        assert _max_err(r["two_axis"], logits) < TOL
        assert _max_err(r["two_axis"], jlogits) < TOL
