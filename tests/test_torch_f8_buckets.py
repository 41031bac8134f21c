"""A request prefilled at a batch's bucket instead of its own (ROADMAP F8),
pinned against the reference on the CPU.

The 14-id prompt "hello world 0" alone takes prefill bucket 32; admitted
beside a 103-id prompt in one batch it takes the batch's bucket, 128.
Both packages' front doors (``llama_tiny(128)``, the same JAX-drawn
weights, f32 and bf16) serve the two prompts in one batched admission,
and each package's streams are held to its own per-stream
``SpeculativeEngine``; the port's streams to JAX's.  What each package
does to the row's bits is pinned too: in f32 both give the short row other
next-token logits in the batch than alone (JAX by a few 1e-6, the port
by less), in bf16 both give the same bits; at this input neither
difference moves a greedy token.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import frontdoor as jfd  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo.models import speculative as jsp  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import frontdoor as tfd  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.models import speculative as tsp  # noqa: E402

SHORT = "hello world 0"  # 14 ids with BOS: bucket 32 alone
LONG = "x" * 102  # 103 ids: the batch's bucket, 128
TOKENS = 8
# How far the short row's f32 logits may move between its bucket and the
# batch's (JAX: 3.1e-6, the port: 7.2e-7 on the CPU): rounding, not a
# different computation.
F32_DRIFT = 1e-5


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def packages(request):
    """Each package's (front-door module, speculative module, a function
    making an engine) over one set of JAX-drawn weights."""
    torch.set_num_threads(1)
    cj = dataclasses.replace(jl.llama_tiny(max_seq_len=128), dtype=getattr(jnp, request.param))
    ct = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=getattr(torch, request.param))
    pj = jl.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), ct, "cpu")
    return request.param, {
        "jax": (jfd, jsp, lambda: js.ServeEngine(cfg=cj, params=pj)),
        "port": (tfd, tsp, lambda: ts.ServeEngine(cfg=ct, params=pt, device="cpu")),
    }


def test_the_bucket_of_a_batch_and_of_the_request_differ():
    cap = tl.llama_tiny(max_seq_len=128).max_seq_len - 2
    ids = [ts.encode_bytes(p, cap) for p in (SHORT, LONG)]
    assert [len(i) for i in ids] == [14, 103]
    assert [ts._bucket(len(i), (32, 64, 128)) for i in ids] == [32, 128]


def test_mixed_bucket_admission_streams_against_the_per_stream_engine(packages, monkeypatch):
    """One batched admission of both prompts; each package's streams
    equal its own per-stream engine's, and the port's equal JAX's."""
    _dtype, sides = packages
    streams = {}
    for name, (mod, spec_mod, make) in sides.items():
        batches = []
        admit = mod.FrontDoorEngine._admit_batch

        def recorded(self, slots, reqs, _admit=admit, _seen=batches):
            _seen.append(len(reqs))
            return _admit(self, slots, reqs)

        monkeypatch.setattr(mod.FrontDoorEngine, "_admit_batch", recorded)
        target, draft = make(), make()
        fd = mod.FrontDoorEngine(target, draft, k=3, max_slots=2)
        ids = [fd.submit(p, max_new_tokens=TOKENS, stop_at_eos=False) for p in (SHORT, LONG)]
        results = fd.run()
        assert batches == [2], name  # one admission: the short row at bucket 128
        spec = spec_mod.SpeculativeEngine(target, draft, k=3)
        per_stream = [spec.generate(p, max_new_tokens=TOKENS, stop_at_eos=False)
                      for p in (SHORT, LONG)]
        streams[name] = [results[i] for i in ids]
        assert streams[name] == per_stream, name
        assert all(len(s) == TOKENS for s in streams[name])
    assert streams["port"] == streams["jax"]


def test_a_prefills_bits_across_buckets_in_each_package(packages):
    """The short row's next-token logits, prefilled beside the long one
    and alone: f32 rounds differently at the two buckets in both packages
    (JAX's difference is not 0), bf16 gives the same bits in both."""
    dtype, sides = packages
    for name, (_mod, _spec, make) in sides.items():
        engine = make()
        cap = engine.generation_prompt_cap()
        rows = [ts.encode_bytes(SHORT, cap), ts.encode_bytes(LONG, cap)]
        batch, _ = engine._prefill_rows(rows, 0)
        alone, _ = engine._prefill_rows(rows[:1], 0)
        batch, alone = (np.asarray(torch.as_tensor(np.array(x, np.float32)))
                        if name == "jax" else x.float().numpy() for x in (batch, alone))
        drift = float(np.abs(batch[0] - alone[0]).max())
        if dtype == "bfloat16":
            assert drift == 0.0, name
        else:
            assert drift <= F32_DRIFT, name
            if name == "jax":
                assert drift > 0.0  # the reference does not keep f32 bits across buckets
