"""Safety governor: ``tpuslo_torch.safety`` against ``tpuslo.safety``.

Every case of ``tests/test_safety.py`` is written once, as a function of
one package's ``safety`` module, run on the JAX package's and on the
port's, and must observe the same values on both; the JAX test's own
assertions hold on each.
"""

from __future__ import annotations

import dataclasses

import pytest

from tpuslo import safety as jsafety
from tpuslo_torch import safety as tsafety


def both(scenario):
    """Run ``scenario(safety)`` on both packages, require equal
    observations, return the port's."""
    want, got = scenario(jsafety), scenario(tsafety)
    assert got == want
    return got


def test_the_port_exports_the_same_names():
    assert tsafety.__all__ == jsafety.__all__


class FakeSampler:
    def __init__(self, samples):
        self._samples = iter(samples)

    def sample(self):
        return next(self._samples)


def _guard(safety, *ticks):
    return safety.OverheadGuard(
        3.0,
        sampler=FakeSampler([safety.CPUSample(*t) for t in ticks]),
        num_cpus=4,
    )


class TestOverheadGuard:
    def test_first_evaluation_invalid(self):
        def run(safety):
            result = _guard(safety, (100, 10000)).evaluate()
            assert not result.valid
            assert not result.over_budget
            return dataclasses.asdict(result)

        both(run)

    def test_within_budget(self):
        def run(safety):
            guard = _guard(safety, (100, 10000), (102, 10400))
            guard.evaluate()
            result = guard.evaluate()
            assert result.valid
            # (2/400)*100*4 = 2.0%
            assert result.cpu_pct == pytest.approx(2.0)
            assert not result.over_budget
            return dataclasses.asdict(result)

        both(run)

    def test_over_budget(self):
        def run(safety):
            guard = _guard(safety, (100, 10000), (120, 10400))
            guard.evaluate()
            result = guard.evaluate()
            assert result.cpu_pct == pytest.approx(20.0)
            assert result.over_budget
            return dataclasses.asdict(result)

        both(run)

    def test_counter_reset_invalid(self):
        def run(safety):
            guard = _guard(safety, (100, 10000), (50, 9000))
            guard.evaluate()
            result = guard.evaluate()
            assert not result.valid
            return dataclasses.asdict(result)

        both(run)

    def test_rejects_nonpositive_budget(self):
        def run(safety):
            with pytest.raises(ValueError) as err:
                safety.OverheadGuard(0)
            return str(err.value)

        both(run)

    def test_proc_sampler_reads_real_proc(self):
        # As in the JAX test: a host that hides /proc, or serves a stub
        # whose machine counters read zero, says nothing about the
        # sampler, so the case skips with the reason.
        try:
            sample = tsafety.ProcCPUSampler().sample()
        except (OSError, ValueError) as exc:
            pytest.skip(f"proc interface unavailable on this host: {exc}")
        if sample.total_ticks <= 0:
            pytest.skip(
                "proc interface is virtualized (machine tick counters "
                "in /proc/stat read zero); real-host behavior is "
                "covered by the FakeSampler tests"
            )
        assert sample.total_ticks > 0
        assert sample.proc_ticks >= 0


def _result(safety, cpu_pct, budget_pct=3.0, valid=True):
    return safety.OverheadResult(
        cpu_pct=cpu_pct,
        budget_pct=budget_pct,
        over_budget=cpu_pct > budget_pct,
        valid=valid,
    )


class TestShedRecoveryPolicy:
    def test_restores_after_n_consecutive_under_budget_cycles(self):
        def run(safety):
            policy = safety.ShedRecoveryPolicy(cycles=3, headroom_factor=0.8)
            notes = [policy.note(_result(safety, 1.0)) for _ in range(3)]
            assert notes == [False, False, True]
            # Streak restarts after each authorized restore.
            assert policy.streak == 0
            notes.append(policy.note(_result(safety, 1.0)))
            assert not notes[-1]
            return notes

        both(run)

    def test_over_budget_resets_streak(self):
        def run(safety):
            policy = safety.ShedRecoveryPolicy(cycles=2)
            notes = [policy.note(_result(safety, pct)) for pct in (1.0, 9.0, 1.0, 1.0)]
            assert notes == [False, False, False, True]
            return notes

        both(run)

    def test_headroom_hysteresis_blocks_borderline_cycles(self):
        # 2.5% is under the 3% budget but above the 2.4% (0.8x) recovery
        # line: restoring there would flap straight back into shedding.
        def run(safety):
            policy = safety.ShedRecoveryPolicy(cycles=1, headroom_factor=0.8)
            notes = [policy.note(_result(safety, pct)) for pct in (2.5, 2.3)]
            assert notes == [False, True]
            return notes

        both(run)

    def test_invalid_samples_do_not_break_streak(self):
        def run(safety):
            policy = safety.ShedRecoveryPolicy(cycles=2)
            notes = [
                policy.note(_result(safety, 1.0)),
                policy.note(_result(safety, 0.0, valid=False)),
                policy.note(_result(safety, 1.0)),
            ]
            assert notes == [False, False, True]
            return notes

        both(run)

    @pytest.mark.parametrize("kw", [{"cycles": 0}, {"headroom_factor": 1.5}])
    def test_rejects_bad_params(self, kw):
        def run(safety):
            with pytest.raises(ValueError) as err:
                safety.ShedRecoveryPolicy(**kw)
            return str(err.value)

        both(run)


class TestRateLimiter:
    def test_burst_then_deny(self):
        def run(safety):
            now = [0.0]
            limiter = safety.RateLimiter(10, burst=5, clock=lambda: now[0])
            allowed = [limiter.allow() for _ in range(6)]
            assert allowed == [True] * 5 + [False]
            return allowed

        both(run)

    def test_refill_over_time(self):
        def run(safety):
            now = [0.0]
            limiter = safety.RateLimiter(10, burst=5, clock=lambda: now[0])
            for _ in range(5):
                limiter.allow()
            now[0] = 0.25  # refills 2.5 tokens
            allowed = [limiter.allow() for _ in range(3)]
            assert allowed == [True, True, False]
            return allowed, limiter.tokens

        both(run)

    def test_capacity_capped(self):
        def run(safety):
            now = [0.0]
            limiter = safety.RateLimiter(10, burst=5, clock=lambda: now[0])
            now[0] = 100.0
            limiter.allow()
            assert limiter.tokens == pytest.approx(4.0)
            return limiter.tokens

        both(run)

    def test_rejects_zero_rate(self):
        def run(safety):
            with pytest.raises(ValueError) as err:
                safety.RateLimiter(0)
            return str(err.value)

        both(run)

    def test_exported_budget_crosses_the_packages(self):
        """A limiter's exported budget restores into the other
        package's limiter with the same tokens, both ways."""
        now = [0.0]
        for src, dst in ((jsafety, tsafety), (tsafety, jsafety)):
            limiter = src.RateLimiter(10, burst=10, clock=lambda: now[0])
            for _ in range(7):
                limiter.allow()
            restored = dst.RateLimiter(10, burst=10, clock=lambda: now[0])
            restored.restore_state(limiter.export_state())
            assert restored.tokens == limiter.tokens == 3.0
