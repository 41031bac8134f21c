"""Long-context sp serving (``tpuslo_torch.models.longserve``) against
``tpuslo.models.longserve``: a counterpart of each test in
``tests/test_longserve.py`` on bf16 ``llama_tiny`` with JAX's weights
carried over by the bridge, the port over gloo ranks on the CPU (one
group per world size, ``test_torch_sp_ranks.longserve_checks``) and JAX
over a CPU mesh of as many devices.

* sp 2 and sp 4 prefill logits within JAX's 5e-2 of JAX's ``sp_prefill``
  and of the port's plain ``prefill``; the context stays split (each rank
  holds S / sp positions), and gathered it is JAX's context KV;
* the sp 4 decode chain equal to JAX's ``sp_generate`` and to the plain
  prefill-and-decode chain, token for token (JAX's inputs);
* one sp 2 decode step within 5e-2 of the plain decode step;
* the rejections: an indivisible length, the tail budget, a full tail, an
  unknown kv dtype;
* the int8 context's structure and bytes, and its decode close to bf16
  (``slow`` in JAX; fast here on tiny shapes);
* Mixtral's ``sp_generate`` (``mixtral_tiny``, drop-free) over 2 ranks
  equal to JAX's over 2 devices, and a droppy config refused.
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
from tpuslo.models import longserve as jls  # noqa: E402
from tpuslo.models import mixtral as jmx  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import longserve as tls  # noqa: E402
from tpuslo_torch.models import mixtral as tmx  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

TOL = 5e-2
CFG_J = jl.llama_tiny(max_seq_len=256)
CFG_T = tl.llama_tiny(max_seq_len=256)


def _mesh(sp: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:sp]), ("sp",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randint(seed: int, shape, vocab: int = CFG_J.vocab_size) -> np.ndarray:
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, vocab))


@pytest.fixture(scope="module")
def weights():
    return {"llama": jl.init_params(jax.random.PRNGKey(0), CFG_J),
            "moe": jmx.init_params(jax.random.PRNGKey(0), jmx.mixtral_tiny())}


@pytest.fixture(scope="module")
def inputs(weights):
    """JAX's test inputs; the decode step's token is the plain prefill's
    greedy token, as in JAX's test."""
    step = _randint(1, (1, 32))
    ref_logits, _ = jl.prefill(weights["llama"], jnp.asarray(step),
                               jl.init_kv_cache(CFG_J, 1), CFG_J)
    return {"prefill": _randint(1, (2, 64)), "chain": _randint(1, (2, 32)), "step": step,
            "step_tok": np.array(jnp.argmax(ref_logits, -1)), "int8": _randint(2, (1, 32)),
            "int8_generate": _randint(3, (1, 32)),
            "moe": _randint(5, (1, 32), jmx.mixtral_tiny().vocab_size)}


@pytest.fixture(scope="module")
def port_params(weights):
    return bridge.params_from_numpy(_np(weights["llama"]), CFG_T, "cpu")


@pytest.fixture(scope="module")
def groups(weights, inputs):
    """One group of ranks per world size, run at its first use."""
    ran: dict = {}

    def get(world: int):
        if world not in ran:
            ran[world] = tmesh.run_ranks(
                ranks.longserve_checks, world, timeout_s=ranks.RANK_TIMEOUT_S,
                args=(_np(weights["llama"]), _np(weights["moe"]), inputs))
        return ran[world]

    return get


def _plain_chain(params, tokens: torch.Tensor, n: int) -> np.ndarray:
    cache = tl.init_kv_cache(CFG_T, tokens.shape[0], device="cpu")
    logits, cache = tl.prefill(params, tokens, cache, CFG_T)
    out = [logits.argmax(dim=-1)]
    for _ in range(n - 1):
        logits, cache = tl.decode_step(params, out[-1], cache, CFG_T)
        out.append(logits.argmax(dim=-1))
    return torch.stack(out, dim=1).numpy()


def _fake_mesh(sp: int):
    """A mesh of ``sp`` ranks with no group: the refusals below raise
    before any collective."""
    return tmesh.Mesh(None, torch.device("cpu"), backend="gloo", axes=(("sp",), (sp,)))


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_prefill_matches_jax_and_plain(groups, weights, inputs, port_params, sp):
    tokens = inputs["prefill"]
    want, jcache = jls.sp_prefill(weights["llama"], jnp.asarray(tokens), CFG_J, _mesh(sp))
    plain, _ = tl.prefill(port_params, torch.from_numpy(tokens).long(),
                          tl.init_kv_cache(CFG_T, 2, device="cpu"), CFG_T)
    for r in groups(sp):
        assert np.abs(r["prefill_logits"] - np.asarray(want)).max() < TOL
        assert np.abs(r["prefill_logits"] - plain.float().numpy()).max() < TOL
        assert r["tail_len"] == 0
        assert r["ctx_piece"][2] == 64 // sp and r["k_ctx"].shape[2] == 64
        np.testing.assert_allclose(r["k_ctx"], np.asarray(jcache["k_ctx"], np.float32),
                                   atol=TOL)


def test_sp_decode_matches_jax_and_the_plain_chain(groups, weights, inputs, port_params):
    tokens = inputs["chain"]
    want = np.asarray(jls.sp_generate(weights["llama"], jnp.asarray(tokens), CFG_J, _mesh(4),
                                      max_new_tokens=6))
    plain = _plain_chain(port_params, torch.from_numpy(tokens).long(), 6)
    for r in groups(4):
        np.testing.assert_array_equal(r["chain"], want)
        np.testing.assert_array_equal(r["chain"], plain)


def test_sp_decode_logits_close(groups, weights, inputs, port_params):
    tokens = torch.from_numpy(inputs["step"]).long()
    _, cache = tl.prefill(port_params, tokens, tl.init_kv_cache(CFG_T, 1, device="cpu"), CFG_T)
    plain, _ = tl.decode_step(port_params, torch.from_numpy(inputs["step_tok"]).long(), cache,
                              CFG_T)
    _, jcache = jl.prefill(weights["llama"], jnp.asarray(inputs["step"]),
                           jl.init_kv_cache(CFG_J, 1), CFG_J)
    jstep, _ = jl.decode_step(weights["llama"], jnp.asarray(inputs["step_tok"]), jcache, CFG_J)
    for r in groups(2):
        assert r["step_tail_len"] == 1
        assert np.abs(r["step_logits"] - plain.numpy()).max() < TOL
        assert np.abs(r["step_logits"] - np.asarray(jstep)).max() < TOL


def test_sp_prefill_rejects_indivisible(port_params):
    with pytest.raises(ValueError, match="not divisible"):
        tls.sp_prefill(port_params, torch.zeros((1, 30), dtype=torch.long), CFG_T,
                       _fake_mesh(4))


def test_sp_tail_budget_guard(port_params):
    with pytest.raises(ValueError, match="tail_max"):
        tls.sp_generate(port_params, torch.zeros((1, 32), dtype=torch.long), CFG_T,
                        _fake_mesh(2), max_new_tokens=8, tail_max=8)


def test_sp_decode_tail_full_raises(groups):
    for r in groups(2):
        assert r["tail_full"] is not None and "tail buffer full (2/2)" in r["tail_full"]


def test_sp_int8_context_kv_structure_and_bytes(groups):
    """int8 context: dict leaves, under 0.8 of the bf16 context bytes, the
    tail in the model dtype; the codes are the context's own, quantized
    per (position, kv head) as ``kv_cache.quantize_kv`` does."""
    for r in groups(4):
        got = r["int8"]
        assert got["keys"] == ["q", "s"] and got["q_dtype"] == "torch.int8"
        assert got["tail_dtype"] == "torch.bfloat16" and got["q_shape"][2] == 16
        assert got["int8_bytes"] < 0.8 * got["bf16_bytes"]
        codes = np.round(r["k_ctx"][:, :1] / got["s"][..., None]).clip(-127, 127)
        assert np.mean(codes != got["q"]) < 0.01


def test_sp_int8_context_decode_close_to_bf16(groups):
    for r in groups(2):
        assert r["int8_prefill_err"] < 1e-5  # the logits come before the quantization
        assert all(e < 0.25 for e in r["int8_decode_errs"]), r["int8_decode_errs"]


def test_sp_generate_int8_runs(groups):
    assert all(r["int8_generate"] == (1, 4) for r in groups(2))


def test_sp_prefill_rejects_unknown_kv_dtype(port_params):
    with pytest.raises(ValueError, match="kv_dtype"):
        tls.sp_prefill(port_params, torch.zeros((1, 32), dtype=torch.long), CFG_T,
                       _fake_mesh(2), kv_dtype="fp8")


def test_mixtral_sp_generate_equals_jax(groups, weights, inputs):
    want = np.asarray(jmx.sp_generate(weights["moe"], jnp.asarray(inputs["moe"]),
                                      jmx.mixtral_tiny(), _mesh(2), max_new_tokens=5))
    for r in groups(2):
        np.testing.assert_array_equal(r["moe"], want)


def test_mixtral_sp_generate_rejects_a_droppy_config():
    import dataclasses

    droppy = dataclasses.replace(tmx.mixtral_tiny(), capacity_factor=1.0)
    with pytest.raises(ValueError, match="capacity_factor"):
        tmx.sp_generate(tmx.init_params(0, droppy, "cpu"), torch.zeros((1, 32), dtype=torch.long),
                        droppy, _fake_mesh(4), max_new_tokens=2)
