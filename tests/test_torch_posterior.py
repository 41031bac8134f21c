"""The port's batched posterior (``tpuslo_torch.columnar.posterior``).

Mirrors the numpy cases of ``tests/test_columnar_parity.py::
TestPosteriorParity`` and all of ``tests/test_columnar.py::
TestPosteriorJitAutoTuner``.  The torch f64 lane runs here on the CPU
(``device="cpu"``) and is held to ``_numpy_kernel`` within 1e-10 in soft
and hard mode; ``_numpy_kernel`` is held to the JAX package's numpy
kernel.  The JAX jit lane is never the reference (it does not import on
every box).  On the card the same lane runs in ``chip_smoke.py``.
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np
import pytest

from tpuslo.attribution import calibrate as jcalibrate
from tpuslo.columnar import posterior as jposterior
from tpuslo_torch.attribution.calibrate import calibrated_attributor
from tpuslo_torch.columnar import posterior
from tpuslo_torch.columnar.posterior import (
    JIT_PROBE_MAX_ROWS,
    _numpy_kernel,
    _row_bucket,
    _torch_kernel,
    log_posterior_batch,
)
from tpuslo_torch.faultreplay import generate_fault_samples

START = datetime(2026, 1, 1, tzinfo=timezone.utc)
#: The JAX package's own numpy-vs-jit bar.
POSTERIOR_TOL = 1e-10


@pytest.fixture(scope="module")
def attributor():
    return calibrated_attributor()


def _batch_inputs(attributor, n=256, seed=4):
    mats = attributor._matrices().kernel
    rng = np.random.default_rng(seed)
    n_sig = len(attributor.likelihoods)
    values = np.abs(rng.lognormal(2.0, 1.5, (n, n_sig)))
    values[rng.random((n, n_sig)) < 0.2] = 0.0
    observed = rng.random((n, n_sig)) < 0.9
    return mats, values, observed


class TestPosteriorParity:
    def test_scalar_vs_kernel_ranking(self, attributor):
        samples = []
        for scenario in ("ici_drop", "hbm_pressure"):
            samples.extend(generate_fault_samples(scenario, 10, START))
        batch = attributor.attribute_batch(samples, use_torch=False)
        single = [attributor.attribute_sample(s) for s in samples]
        assert ([a.predicted_fault_domain for a in batch]
                == [a.predicted_fault_domain for a in single])
        for a, b in zip(batch, single):
            assert a.confidence == pytest.approx(b.confidence, abs=1e-9)

    @pytest.mark.parametrize("soft,seed", [(True, 4), (False, 9), (True, 5)])
    def test_numpy_vs_torch_lane(self, attributor, soft, seed):
        mats, values, observed = _batch_inputs(attributor, seed=seed)
        sharpness = attributor.sharpness if soft else 1.0
        np_post, np_w, np_obs = log_posterior_batch(
            values, observed, mats, soft=soft, sharpness=sharpness, use_torch=False)
        t_post, t_w, t_obs = log_posterior_batch(
            values, observed, mats, soft=soft, sharpness=sharpness, use_torch=True,
            device="cpu")
        assert t_post.dtype == t_w.dtype == np.float64 and t_obs.dtype == bool
        assert np.abs(np_post - t_post).max() <= POSTERIOR_TOL
        assert (np_post.argmax(axis=1) == t_post.argmax(axis=1)).all()
        assert np.abs(np_w - t_w).max() <= 1e-12
        assert (np_obs == t_obs).all()

    @pytest.mark.parametrize("soft", [True, False])
    def test_numpy_kernel_is_the_jax_packages(self, attributor, soft):
        """The f64 source of truth is bit for bit the JAX package's numpy
        path on the same tables."""
        mats, values, observed = _batch_inputs(attributor, seed=7)
        jmats = jcalibrate.calibrated_attributor()._matrices().kernel
        got = _numpy_kernel(values, observed, mats, soft, attributor.sharpness)
        want = jposterior._numpy_kernel(values, observed, jmats, soft, attributor.sharpness)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_torch_lane_on_degenerate_rows(self, attributor):
        """All-zero, all-unobserved and huge values: the lanes agree."""
        mats, values, observed = _batch_inputs(attributor, n=6, seed=3)
        values[0] = 0.0
        observed[1] = False
        values[2] = 1e300
        values[3, ::2] = 1e-320
        for soft in (True, False):
            a = _numpy_kernel(values, observed, mats, soft, 1.5)
            b = _torch_kernel(values, observed, mats, soft, 1.5, "cpu")
            assert np.abs(a[0] - b[0]).max() <= POSTERIOR_TOL
            assert (a[2] == b[2]).all()

    def test_attribute_batch_use_torch_matches_numpy(self, attributor):
        samples = generate_fault_samples("xla_recompile_storm", 15, START)
        a = attributor.attribute_batch(samples, use_torch=False)
        b = attributor.attribute_batch(samples, use_torch=True, device="cpu")
        assert [x.predicted_fault_domain for x in a] == [x.predicted_fault_domain for x in b]
        for x, y in zip(a, b):
            assert x.confidence == pytest.approx(y.confidence, abs=1e-9)

    def test_use_torch_without_a_card_raises(self, attributor, monkeypatch):
        """A forced torch lane on the default device needs a card: it
        raises rather than quietly running numpy."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        mats, values, observed = _batch_inputs(attributor, n=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            log_posterior_batch(values, observed, mats, soft=True, sharpness=1.5,
                                use_torch=True)
        samples = generate_fault_samples("ici_drop", 2, START)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            attributor.attribute_batch(samples, use_torch=True)
        monkeypatch.setenv("TPUSLO_COLUMNAR_JIT", "1")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            attributor.attribute_batch(samples)


class TestPosteriorJitAutoTuner:
    """The measured engagement policy: auto mode may only engage the
    torch lane where a timed probe on the call's own inputs says it
    wins, and considers it only where a card is present."""

    def _inputs(self, attributor, n_rows: int):
        mats = attributor._matrices().kernel
        rng = np.random.default_rng(11)
        n_sig = len(attributor.likelihoods)
        values = np.abs(rng.lognormal(2.0, 1.5, (n_rows, n_sig)))
        observed = rng.random((n_rows, n_sig)) < 0.9
        return values, observed, mats, attributor.sharpness

    def test_probe_bucket_rounds_down_to_measured_rows(self):
        assert _row_bucket(5000) == 4096
        assert _row_bucket(4096) == 4096
        assert _row_bucket(8191) == 4096
        assert _row_bucket(1) == 1
        assert _row_bucket(10 ** 9) == JIT_PROBE_MAX_ROWS
        for n in (1, 3, 4097, 70000):
            assert _row_bucket(n) == jposterior._row_bucket(n)

    @pytest.mark.parametrize("card", [True, False])
    def test_below_floor_never_probes(self, monkeypatch, card):
        monkeypatch.delenv("TPUSLO_COLUMNAR_JIT", raising=False)
        monkeypatch.setattr(posterior, "cuda_available", lambda: card)
        assert posterior.resolve_use_torch(100, None) is False
        assert posterior.resolve_use_torch(posterior.JIT_MIN_BATCH - 1, None) is False

    def test_auto_considers_the_torch_lane_only_on_a_card(self, monkeypatch):
        monkeypatch.delenv("TPUSLO_COLUMNAR_JIT", raising=False)
        monkeypatch.delenv("TPUSLO_COLUMNAR_JIT_MIN_ROWS", raising=False)
        monkeypatch.setattr(posterior, "cuda_available", lambda: False)
        assert posterior.resolve_use_torch(1 << 20, None) is False
        monkeypatch.setattr(posterior, "cuda_available", lambda: True)
        assert posterior.resolve_use_torch(1 << 20, None) is None

    def test_explicit_and_env_override_skip_probe(self, monkeypatch):
        assert posterior.resolve_use_torch(10, True) is True
        assert posterior.resolve_use_torch(1 << 20, False) is False
        monkeypatch.setenv("TPUSLO_COLUMNAR_JIT", "0")
        assert posterior.resolve_use_torch(1 << 20, None) is False
        monkeypatch.setenv("TPUSLO_COLUMNAR_JIT", "1")
        assert posterior.resolve_use_torch(1 << 20, None) is True

    def test_min_rows_env_moves_the_floor(self, monkeypatch):
        monkeypatch.delenv("TPUSLO_COLUMNAR_JIT", raising=False)
        monkeypatch.setattr(posterior, "cuda_available", lambda: True)
        monkeypatch.setenv("TPUSLO_COLUMNAR_JIT_MIN_ROWS", "50000")
        assert posterior.resolve_use_torch(8192, None) is False
        assert posterior.resolve_use_torch(50000, None) is None
        monkeypatch.setenv("TPUSLO_COLUMNAR_JIT_MIN_ROWS", "junk")
        assert posterior.resolve_use_torch(posterior.JIT_MIN_BATCH, None) is None

    def test_constants_equal_jax(self):
        for name in ("JIT_MIN_BATCH", "JIT_WIN_MARGIN", "JIT_PROBE_MAX_ROWS"):
            assert getattr(posterior, name) == getattr(jposterior, name)

    def test_auto_probe_caches_and_reports(self, attributor, monkeypatch):
        """The probe times both lanes (the torch lane here on the CPU, as
        if a card were present) on the call's own inputs."""
        monkeypatch.delenv("TPUSLO_COLUMNAR_JIT", raising=False)
        monkeypatch.delenv("TPUSLO_COLUMNAR_JIT_MIN_ROWS", raising=False)
        monkeypatch.setattr(posterior, "_AUTO_PROBES", {})
        monkeypatch.setattr(posterior, "cuda_available", lambda: True)
        values, observed, mats, sharpness = self._inputs(attributor, posterior.JIT_MIN_BATCH)
        post, _w, _o = log_posterior_batch(
            values, observed, mats, soft=True, sharpness=sharpness, use_torch=None,
            device="cpu")
        report = posterior.auto_report()
        assert len(report["probes"]) == 1
        (probe,) = report["probes"].values()
        assert probe["rows"] == posterior.JIT_MIN_BATCH
        assert probe["speedup"] > 0 and probe["numpy_s"] > 0 and probe["torch_s"] > 0
        expected, _w2, _o2 = log_posterior_batch(
            values, observed, mats, soft=True, sharpness=sharpness,
            use_torch=probe["jit_wins"], device="cpu")
        assert np.allclose(post, expected, atol=1e-9)
        log_posterior_batch(values, observed, mats, soft=True, sharpness=sharpness,
                            use_torch=None, device="cpu")
        assert len(posterior.auto_report()["probes"]) == 1
        threshold = posterior.auto_threshold()
        if probe["jit_wins"]:
            assert threshold == posterior.JIT_MIN_BATCH
        else:
            assert threshold is None

    def test_auto_threshold_is_the_smallest_winning_bucket(self, monkeypatch):
        monkeypatch.setattr(posterior, "_AUTO_PROBES", {
            (True, 1.5, 22, 8192): {"jit_wins": True},
            (True, 1.5, 22, 4096): {"jit_wins": False},
            (True, 1.5, 22, 16384): {"jit_wins": True},
        })
        assert posterior.auto_threshold() == 8192
        monkeypatch.setattr(posterior, "_AUTO_PROBES", {})
        assert posterior.auto_threshold() is None
