"""The port's serving bench (``tpuslo_torch.benchmark.serving_bench``)
against the JAX package's (``tpuslo.benchmark.serving_bench``) on the CPU.

The bandwidth and percentile folds and the model pick must be equal; the
seeded device-plane and profiler lanes equal but for their timed fields;
the prefix, long-prompt and shared-prefix lanes, run on ``llama_tiny`` in
f32 over the same weights (drawn by JAX), emit the same token streams and
the same deterministic fields; the ``xla_launch`` join over a CPU capture
joins through the port's matcher.  The lanes' times are the CPU's and
are not compared.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.benchmark import serving_bench as jsb  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import paged_kv as jpk  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo_torch.benchmark import serving_bench as tsb  # noqa: E402
from tpuslo_torch.deviceplane import roofline as tr  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import paged_kv as tpk  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402

CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=512), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=512), dtype=torch.float32)
BUCKETS = (32, 64, 128, 256)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    pj = jl.init_params(jax.random.PRNGKey(0), CFG_J)
    return pj, bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")


def _engines(weights):
    pj, pt = weights
    return (js.ServeEngine(cfg=CFG_J, params=pj, prefill_buckets=BUCKETS),
            ts.ServeEngine(cfg=CFG_T, params=pt, prefill_buckets=BUCKETS, device="cpu"))


def _recording(monkeypatch, cls, name: str, log: list, convert):
    """Wrap ``cls.name`` so that each call's output lands in ``log``."""
    real = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        out = list(out) if name == "generate" else out
        log.append(convert(out))
        return iter(out) if name == "generate" else out

    monkeypatch.setattr(cls, name, wrapper)


def _stream_logs(monkeypatch):
    """Record every stream and batch each package's engines emit."""
    logs = {"jax": [], "port": []}
    for side, serve_mod, paged_mod in (("jax", js, jpk), ("port", ts, tpk)):
        _recording(monkeypatch, serve_mod.ServeEngine, "generate", logs[side],
                   lambda events: [int(e.token_id) for e in events])
        _recording(monkeypatch, serve_mod.ServeEngine, "generate_batch", logs[side],
                   lambda rows: [[int(t) for t in r] for r in rows])
        _recording(monkeypatch, paged_mod.PagedBatchingEngine, "run", logs[side],
                   lambda results: {rid: [int(t) for t in toks] for rid, toks in results.items()})
    return logs


# ---- folds and the model pick --------------------------------------------


@pytest.mark.parametrize("n_params,kv,param_bytes", [
    (3_606_752_256, 1_879_048_192, 2.0), (8_030_261_248, 268_435_456, 1.0), (1e6, 0, 2.0)])
def test_decode_step_hbm_bytes_equal_jax(n_params, kv, param_bytes):
    assert (tsb.decode_step_hbm_bytes(n_params, kv, param_bytes=param_bytes)
            == jsb.decode_step_hbm_bytes(n_params, kv, param_bytes=param_bytes))


@pytest.mark.parametrize("tps,batch,step_bytes,peak", [
    (80.5, 1, 7.2e9, tr.H100_PEAK_HBM_BW), (610.0, 8, 9.1e9, tr.H100_PEAK_HBM_BW),
    (12.0, 0, 1e9, None), (3.3, 8, 2e9, 819e9)])
def test_bandwidth_report_equals_jax(tps, batch, step_bytes, peak):
    assert (tsb.bandwidth_report(tps, batch, step_bytes, peak)
            == jsb.bandwidth_report(tps, batch, step_bytes, peak))


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.95, 0.99, 1.0])
def test_percentile_equals_jax(q):
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 7, 100):
        values = rng.normal(size=n).tolist()
        assert tsb._percentile(values, q) == jsb._percentile(values, q)


@pytest.mark.parametrize("limit", [None, 4e9, 16e9, 80e9, 85_031_714_816])
@pytest.mark.parametrize("bytes_per_param", [2.0, 1.0])
def test_pick_model_equals_jax(limit, bytes_per_param):
    assert (tsb._pick_model(limit, bytes_per_param)
            == jsb._pick_model(limit, bytes_per_param))


def test_the_card_picks_3b_in_bf16_and_8b_in_int8():
    """On an 80 GB card: ``llama32_3b(1024)`` for the main lanes, with
    the JAX ``param_count``, and ``llama3_8b`` for the int8 lane."""
    assert tsb._pick_model(80e9) == "llama32_3b"
    assert tsb._pick_model(80e9, bytes_per_param=1.0) == "llama3_8b"
    for name in ("llama3_8b", "llama32_3b", "llama32_1b", "llama_tiny"):
        t, j = tsb._make_config(name), jsb._make_config(name)
        assert tl.param_count(t) == jl.param_count(j)
        assert (t.max_seq_len, t.dim, t.n_layers) == (j.max_seq_len, j.dim, j.n_layers)
    assert tl.param_count(tsb._make_config("llama32_3b")) == 3_606_752_256


def test_auto_without_a_card_exits_2(capsys):
    assert not torch.cuda.is_available()
    assert tsb.main(["--platform", "auto"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---- the seeded lanes ------------------------------------------------------


def test_deviceplane_lane_equals_jax():
    assert tsb._deviceplane_lane() == jsb._deviceplane_lane()


def test_profiler_lane_equals_jax_but_its_timed_fields():
    """At the JAX lane's own roofs (its seeded cost model's), the windows,
    join rates and idle gaps are equal; the capture cost and the EMA
    built from it are the host's time."""
    from tpuslo.deviceplane import roofline as jr

    timed = {"overhead_ema_pct", "mean_capture_cost_ms", "degradations"}
    want = jsb._profiler_lane()
    got = tsb._profiler_lane(roofs=(819e9, jr.V5E_PEAK_BF16_FLOPS))
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in timed} == {
        k: v for k, v in want.items() if k not in timed}
    assert got["min_substantive_join_rate"] >= 0.9


def test_profiler_lane_at_the_h100_row_meets_the_bars():
    got = tsb._profiler_lane(roofs=tr.peaks_for_chip("NVIDIA H100 80GB HBM3"))
    assert got["windows"] == 8 and got["min_substantive_join_rate"] >= 0.9


# ---- the serving lanes on llama_tiny ---------------------------------------


def test_prefix_lane_streams_equal_jax(weights, monkeypatch):
    logs = _stream_logs(monkeypatch)
    j, t = _engines(weights)
    want, got = jsb._prefix_lane(j), tsb._prefix_lane(t)
    assert logs["port"] == logs["jax"] and len(logs["port"]) >= 10
    for key in ("prefix_bytes", "prefix_ids", "suffix_ids", "suffix_bucket", "full_bucket"):
        assert got[key] == want[key], key
    assert set(got) == set(want)


def test_long_prompt_lane_streams_equal_jax(weights, monkeypatch):
    logs = _stream_logs(monkeypatch)
    j, t = _engines(weights)
    want, got = jsb._long_prompt_lane(j), tsb._long_prompt_lane(t)
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3
    assert got["prompt_ids"] == want["prompt_ids"] == CFG_T.max_seq_len - 2
    assert set(got) == set(want)


def test_shared_prefix_lane_streams_equal_jax(weights, monkeypatch):
    logs = _stream_logs(monkeypatch)
    pj, pt = weights
    want = jsb._shared_prefix_lane(CFG_J, pj, (64,))
    got = tsb._shared_prefix_lane(CFG_T, pt, (64,), CPU)
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3
    for key in ("prefix_ids", "n_requests", "pool_blocks", "block_size", "prefix_reuse_hits",
                "shared_prefix_blocks"):
        assert got[key] == want[key], key
    assert set(got) - set(want) == {"k2_launches"} and got["k2_launches"] == 0


def test_xla_launch_join_on_the_cpu_joins_through_the_ports_matcher(weights, monkeypatch):
    """A CPU capture over a 32-token serve: every dispatch's module span
    finds its device-time signal through the port's ``xla_launch`` tier."""
    from tpuslo_torch.correlation import matcher

    tiers = []
    real = matcher.match

    def counted(span, signal, window_ms=0):
        decision = real(span, signal, window_ms)
        tiers.append(decision.tier)
        return decision

    monkeypatch.setattr(matcher, "match", counted)
    _, t = _engines(weights)
    got = tsb._xla_launch_join(t, tsb.BENCH_PROMPT, node="bench-host")
    assert got["xprof_launch_spans"] > 0 and got["device_time_signals"] > 0
    assert got["xla_launch_matches"] > 0 and set(tiers) == {"xla_launch"}
    assert 0 < got["xla_launch_join_rate_substantive"] <= 1.0


@pytest.mark.slow
def test_a_whole_cpu_run_reports_every_lane():
    """``run(platform="cpu")`` end to end (~1 min on the CPU, so outside
    tier-1): every lane of JAX's CPU run is there without an error, the
    measured speculative lane's streams are identical, and no kernel
    launched on the CPU."""
    got = tsb.run(platform="cpu")
    assert got["model"] == "llama_tiny" and got["platform"] == "cpu"
    for lane in ("prefix_cache", "long_prompt", "speculative", "kv", "deviceplane", "profiler"):
        assert "error" not in got[lane], (lane, got[lane])
    for lane in ("int8_kv", "batch_curve", "paged", "shared_prefix"):
        assert "error" not in got["kv"][lane], lane
    assert "error" not in got["speculative_measured"] and got["speculative_measured"]["parity_ok"]
    assert "xprof_error" not in got and got["xla_launch_matches"] > 0
    assert set(got["kernel_launches"].values()) == {0}
    assert got["mfu_prefill"] is None and "hbm_bw_pct" not in got["bw_decode_b1"]


def test_the_moe_lane_reports_the_jax_lanes_keys(monkeypatch):
    """``_bench_moe`` on ``mixtral_tiny`` standing in for ``mixtral_2b6``:
    the JAX lane's keys, its counts from the port's ``param_count``, a
    decode rate, and no kernel launched on the CPU.  The lane the card
    runs is the real config (phase 20 holds its ``n_params`` to JAX's)."""
    from tpuslo_torch.models import mixtral

    monkeypatch.setattr(mixtral, "mixtral_2b6", lambda: mixtral.mixtral_tiny(256))
    got = tsb._bench_moe(None, None, CPU)
    cfg = mixtral.mixtral_tiny(256)
    assert (got["model"], got["n_params"], got["n_params_active"]) == (
        "mixtral_2b6", mixtral.param_count(cfg), mixtral.active_param_count(cfg))
    assert (got["n_experts"], got["top_k"]) == (4, 2)
    assert got["ttft_ms"] > 0 and got["decode_tokens_per_sec"] > 0
    assert "mfu_decode_b1" not in got and "hbm_bw_pct" not in got["bw_decode_b1"]
    assert got["bw_decode_b1"]["bytes_per_step"] == int(
        tsb.decode_step_hbm_bytes(got["n_params_active"], tl.kv_cache_bytes(cfg, 1)))
    assert (got["k1_launches"], got["k2_launches"]) == (0, 0)
    assert "moe" not in tsb.NOT_PORTED


def test_the_measured_speculative_lane_reports_the_jax_lanes_keys():
    """``_speculative_measured_lane`` at 2 training steps per model on both
    packages: the same keys (``note`` comes only with a speedup under 1),
    the same configs and train steps, identical emitted streams and no
    recapture on the port.  The card runs the JAX recipe (chip_smoke
    phase 23)."""
    few = dict(target_steps=2, draft_steps=2, n_tokens=8)
    want = jsb._speculative_measured_lane(**few)
    got = tsb._speculative_measured_lane(**few, device="cpu")
    assert set(got) - {"note"} == set(want) - {"note"}
    assert got["train_steps"] == want["train_steps"] == {"target": 2, "draft": 2}
    for model in ("target", "draft"):
        assert set(got[model]) == set(want[model])
        assert got[model]["n_params"] == want[model]["n_params"]
        assert np.isfinite([got[model]["loss_first"], got[model]["loss_last"]]).all()
    assert got["cost_ratio"] == want["cost_ratio"]
    assert got["parity_ok"] is True and want["parity_ok"] is True
    assert got["spec_retrace_count"] == 0
    assert 0.0 <= got["acceptance_rate"] <= 1.0


def test_the_measured_lanes_target_is_jaxs():
    """F11: the measured lane's default target is the JAX lane's own
    (8 heads of 24 over 4 kv heads), read from the JAX function's
    ``LlamaConfig(...)`` call."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(jsb._speculative_measured_lane).lstrip())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "LlamaConfig"]
    want = {kw.arg: ast.literal_eval(kw.value) for kw in calls[0].keywords}
    assert tsb.MEASURED_TARGET == want
    from tpuslo_torch.models.llama import LlamaConfig

    assert LlamaConfig(**tsb.MEASURED_TARGET).head_dim == 24
