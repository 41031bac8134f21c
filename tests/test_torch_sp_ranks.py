"""Rank programs for the port's sequence-parallel tests
(``test_torch_ring_attention.py``, ``test_torch_longserve.py``,
``test_torch_sp_serve.py``, ``test_torch_mesh.py``).

Each runs inside spawned ranks of one gloo group on the CPU
(``tpuslo_torch.parallel.mesh.run_ranks``), so this module imports
neither JAX nor the JAX package: a spawned rank imports the module that
defines its function.  The tests run one group per world size and per
file; its program runs every check of that file on that world and
returns what each test reads.  The JAX side runs in the test process
and hands the ranks its weights and inputs as numpy.

The tests here need no ranks: the ring with no mesh against the port's
own reference, and the sp cache's layout.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuslo_torch.parallel import mesh as mesh_mod  # noqa: E402

RANK_TIMEOUT_S = 240.0
ring = importlib.import_module("tpuslo_torch.ops.ring_attention")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tokens(a: np.ndarray) -> torch.Tensor:
    return _t(a).long()


def _gathered(x: torch.Tensor, mesh) -> np.ndarray:
    """This rank's piece of the context KV (L, B, S / sp, ...) gathered
    along the sequence: the whole context, in rank order."""
    return mesh_mod.all_gather(x, mesh, "sp", dim=2).float().numpy()


# --- rank programs -------------------------------------------------------------


def sp_mesh_checks(rank: int, world: int) -> dict:
    """``sp_mesh(world)``'s axes seen by this rank, the sum and the max of
    the ranks' ids over its axis, and the mesh's call counts."""
    torch.set_num_threads(1)
    mesh = mesh_mod.sp_mesh(world, devices=["cpu"])
    x = torch.tensor([float(rank), float(10 * rank)])
    return {"axis_names": list(mesh.axis_names), "shape": dict(mesh.shape),
            "rank": mesh.rank("sp"), "plan": mesh.plan,
            "sum": mesh_mod.all_reduce(x, mesh, "sp").tolist(),
            "max": mesh_mod.all_reduce(x, mesh, "sp", op="max").tolist(),
            "max_bf16": mesh_mod.all_reduce(x.bfloat16(), mesh, "sp", op="max").float().tolist(),
            "x_after": x.tolist(), "calls": dict(mesh.calls)}


def ring_checks(rank: int, world: int, cases: dict) -> dict:
    """Each case ``name -> (q, k, v, n_rep)`` (the whole (B, S, H, D)
    inputs): ``ring_attention_sharded`` (n_rep 1) or ``ring_attention`` on
    this rank's piece, gathered (n_rep > 1), with the shifts it made; on
    one rank also the call with no mesh."""
    torch.set_num_threads(1)
    mesh = mesh_mod.sp_mesh(world, devices=["cpu"])
    out: dict = {"out": {}, "calls": {}, "no_mesh": {}}
    for name, (q, k, v, n_rep) in cases.items():
        q, k, v = _t(q), _t(k), _t(v)
        mesh.reset_counts()
        if n_rep == 1:
            got = ring.ring_attention_sharded(q, k, v, mesh)
        else:
            piece = q.shape[1] // world

            def local(t):
                return t[:, rank * piece:(rank + 1) * piece]

            got = ring.ring_attention(local(q), local(k), local(v), mesh, n_rep=n_rep)
            out["calls"][name] = dict(mesh.calls)
            got = mesh_mod.all_gather(got, mesh, "sp", dim=1)
        out["calls"].setdefault(name, dict(mesh.calls))
        out["out"][name] = got
        if world == 1:
            out["no_mesh"][name] = ring.ring_attention(q, k, v, None, n_rep=n_rep)
    return out


def _tiny(max_seq_len: int = 256):
    from tpuslo_torch.models import llama

    return llama.llama_tiny(max_seq_len=max_seq_len)


def longserve_checks(rank: int, world: int, params_np: dict, moe_np: dict | None,
                     inputs: dict) -> dict:
    """Every long-context check of ``test_torch_longserve.py`` at this
    world size, on bf16 ``llama_tiny`` (and ``mixtral_tiny``) with JAX's
    weights: the prefill logits and the context pieces; at sp 4 the decode
    chain and the int8 context's structure; at sp 2 one decode step, the
    full tail, the int8 context's decode, ``sp_generate`` over int8 and
    Mixtral's ``sp_generate``."""
    from tpuslo_torch.models import bridge, llama, longserve, mixtral

    torch.set_num_threads(1)
    cfg = _tiny()
    mesh = mesh_mod.sp_mesh(world, devices=["cpu"])
    params = bridge.params_from_numpy(params_np, cfg, "cpu")
    out: dict = {}
    logits, cache = longserve.sp_prefill(params, _tokens(inputs["prefill"]), cfg, mesh)
    out["prefill_logits"] = logits.float().numpy()
    out["tail_len"] = cache["tail_len"]
    out["ctx_piece"] = tuple(cache["k_ctx"].shape)
    out["k_ctx"] = _gathered(cache["k_ctx"], mesh)
    if world == 4:
        out["chain"] = longserve.sp_generate(params, _tokens(inputs["chain"]), cfg, mesh,
                                             max_new_tokens=6).numpy()
        _, c8 = longserve.sp_prefill(params, _tokens(inputs["prefill"][:1]), cfg, mesh,
                                     kv_dtype="int8")
        q, s = c8["k_ctx"]["q"], c8["k_ctx"]["s"]
        out["int8"] = {"keys": sorted(c8["k_ctx"]), "q_dtype": str(q.dtype),
                       "tail_dtype": str(c8["k_tail"].dtype), "q_shape": tuple(q.shape),
                       "int8_bytes": q.numel() * q.element_size() + s.numel() * s.element_size(),
                       "bf16_bytes": q.numel() * cfg.dtype.itemsize,
                       "q": _gathered(c8["k_ctx"]["q"], mesh),
                       "s": mesh_mod.all_gather(s, mesh, "sp", dim=2).numpy()}
        return out

    tokens = _tokens(inputs["step"])
    _, step_cache = longserve.sp_prefill(params, tokens, cfg, mesh)
    tok = _tokens(inputs["step_tok"])
    step_logits, step_cache = longserve.sp_decode_step(params, tok, step_cache, cfg, mesh)
    out["step_logits"] = step_logits.numpy()
    out["step_tail_len"] = step_cache["tail_len"]

    zeros = torch.zeros((1, 32), dtype=torch.long)
    _, full = longserve.sp_prefill(params, zeros, cfg, mesh, tail_max=2)
    z = torch.zeros((1,), dtype=torch.long)
    for _ in range(2):
        _, full = longserve.sp_decode_step(params, z, full, cfg, mesh)
    try:
        longserve.sp_decode_step(params, z, full, cfg, mesh)
        out["tail_full"] = None
    except ValueError as exc:
        out["tail_full"] = str(exc)

    tokens = _tokens(inputs["int8"])
    logits_bf, cache_bf = longserve.sp_prefill(params, tokens, cfg, mesh)
    logits_i8, cache_i8 = longserve.sp_prefill(params, tokens, cfg, mesh, kv_dtype="int8")
    out["int8_prefill_err"] = float((logits_bf - logits_i8).abs().max())
    errs, tok = [], logits_bf.argmax(dim=-1)
    for _ in range(3):
        lb, cache_bf = longserve.sp_decode_step(params, tok, cache_bf, cfg, mesh)
        li, cache_i8 = longserve.sp_decode_step(params, tok, cache_i8, cfg, mesh)
        errs.append(float((lb - li).abs().max()))
        tok = lb.argmax(dim=-1)
    out["int8_decode_errs"] = errs
    out["int8_generate"] = tuple(longserve.sp_generate(
        params, _tokens(inputs["int8_generate"]), cfg, mesh, max_new_tokens=4,
        kv_dtype="int8").shape)

    mcfg = mixtral.mixtral_tiny()
    mparams = bridge.params_from_numpy(moe_np, mcfg, "cpu")
    out["moe"] = mixtral.sp_generate(mparams, _tokens(inputs["moe"]), mcfg, mesh,
                                     max_new_tokens=5).numpy()
    return out


def _f32_gqa(max_seq_len: int = 64):
    """The JAX sp-serve tests' config: f32, 4 heads over 2 kv heads."""
    from tpuslo_torch.models import llama

    return llama.LlamaConfig(vocab_size=256, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn_dim=64, max_seq_len=max_seq_len, rope_theta=10000.0,
                             dtype=torch.float32)


def sp_serve_checks(rank: int, world: int, params_np: dict, inputs: dict) -> dict:
    """Every check of ``test_torch_sp_serve.py`` at this world size, on the
    f32 GQA config with JAX's weights: at sp 4 the raw prefill (logits and
    the gathered KV), a padded prompt, the handoff with four decode steps
    teacher-forced by the dense path, and the engine's ``ingest_prompt_sp``
    against its ``ingest_prompt`` (logits, three decode steps, and
    ``generate``'s ordinary loop from the installed cache); at sp 2 the
    raw prefill of 48 ids."""
    from tpuslo_torch.models import bridge, llama, serve, sp_serve

    torch.set_num_threads(1)
    cfg = _f32_gqa()
    mesh = mesh_mod.sp_mesh(world, devices=["cpu"])
    params = bridge.params_from_numpy(params_np, cfg, "cpu")
    out: dict = {}
    if world == 2:
        out["two_axis"] = sp_serve.sp_prefill(params, _tokens(inputs["two_axis"]), cfg,
                                              mesh)[0].numpy()
        return out

    logits, ks, vs = sp_serve.sp_prefill(params, _tokens(inputs["dense"]), cfg, mesh)
    out["dense"] = {"logits": logits.numpy(), "ks": _gathered(ks, mesh),
                    "vs": _gathered(vs, mesh)}
    out["padded"] = sp_serve.sp_prefill(params, _tokens(inputs["padded"]), cfg, mesh,
                                        true_length=inputs["true_length"])[0].numpy()

    tokens = _tokens(inputs["handoff"])
    d_logits, d_cache = llama.prefill(params, tokens, llama.init_kv_cache(cfg, 1, device="cpu"),
                                      cfg)
    s_logits, s_cache = sp_serve.sp_prefill_into_cache(
        params, tokens, llama.init_kv_cache(cfg, 1, device="cpu"), cfg, mesh)
    handoff = {"logits": s_logits.numpy(), "length": s_cache["length"],
               "k": s_cache["k"].clone().numpy(), "steps": []}
    tok = d_logits.argmax(dim=-1)
    for _ in range(4):
        dl, d_cache = llama.decode_step(params, tok, d_cache, cfg)
        sl, s_cache = llama.decode_step(params, tok, s_cache, cfg)
        handoff["steps"].append((dl.numpy(), sl.numpy()))
        tok = dl.argmax(dim=-1)
    out["handoff"] = handoff

    ecfg = _f32_gqa(max_seq_len=128)
    engine = serve.ServeEngine(ecfg, params, prefill_buckets=(32,), device="cpu")
    prompt = inputs["prompt"]
    d_logits, d_cache, d_len = engine.ingest_prompt(prompt)
    mesh.reset_counts()
    s_logits, s_cache, s_len = engine.ingest_prompt_sp(prompt, mesh)
    calls = dict(mesh.calls)
    steps, tok = [], d_logits.argmax(dim=-1)
    for _ in range(3):
        dl, d_cache = llama.decode_step(engine.params, tok, d_cache, ecfg)
        sl, s_cache = llama.decode_step(engine.params, tok, s_cache, ecfg)
        steps.append((dl.numpy(), sl.numpy()))
        tok = dl.argmax(dim=-1)
    want = [e.token_id for e in engine.generate(prompt, 8, stop_at_eos=False)]
    engine.ingest_prompt = lambda p, prefix=None: engine.ingest_prompt_sp(p, mesh)
    got = [e.token_id for e in engine.generate(prompt, 8, stop_at_eos=False)]
    out["engine"] = {"d_logits": d_logits.numpy(), "s_logits": s_logits.numpy(),
                     "d_len": d_len, "s_len": s_len, "steps": steps,
                     "generate": want, "generate_sp": got, "calls": calls}
    return out


# --- tests that need no ranks ------------------------------------------------


def test_the_ring_with_no_mesh_is_the_reference():
    gen = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(gen.standard_normal((2, 24, 4, 8), dtype=np.float32))
               for _ in range(3))
    np.testing.assert_allclose(ring.ring_attention(q, k, v).numpy(),
                               ring.reference_causal_attention(q, k, v).numpy(), atol=1e-5)
    # GQA: kv heads repeated in place of their query heads.
    k2, v2 = k[:, :, :2], v[:, :, :2]
    np.testing.assert_allclose(
        ring.ring_attention(q, k2, v2, n_rep=2).numpy(),
        ring.reference_causal_attention(q, k2.repeat_interleave(2, 2),
                                        v2.repeat_interleave(2, 2)).numpy(), atol=1e-5)


def test_the_sp_cache_layout_names_the_split_leaves():
    from tpuslo_torch.models import longserve

    assert longserve.sp_cache_specs() == {"k_ctx": 2, "v_ctx": 2, "k_tail": None,
                                          "v_tail": None, "tail_len": None}
    assert longserve.sp_cache_specs(int8=True)["k_ctx"] == {"q": 2, "s": 2}


def test_a_one_device_sp_mesh_needs_no_group():
    mesh = mesh_mod.sp_mesh(1, devices=["cpu"])
    assert mesh.axis_names == ("sp",) and mesh.shape == {"sp": 1}
    assert mesh.plan is None and not mesh.distributed and mesh.rank("sp") == 0
    with pytest.raises(RuntimeError, match="run_ranks"):
        mesh_mod.sp_mesh(2, devices=["cpu"])


def test_sp_prefill_over_a_one_device_mesh_is_the_call_with_no_mesh():
    from tpuslo_torch.models import llama, longserve

    cfg = dataclasses.replace(_tiny(), dtype=torch.float32)
    params = llama.init_params(0, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(1))
    mesh = mesh_mod.sp_mesh(1, devices=["cpu"])
    got = longserve.sp_generate(params, tokens, cfg, mesh, 4)
    assert torch.equal(got, longserve.sp_generate(params, tokens, cfg, None, 4))
    assert not mesh.calls
