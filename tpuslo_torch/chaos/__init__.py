"""Real fault injectors (importable cores; the port of ``tpuslo/chaos``'s
device half).

The command-line injectors under :mod:`tpuslo_torch.chaos.injectors`
(``python -m tpuslo_torch.chaos.injectors.<name>``) are thin wrappers
over this package so the injection logic is unit-testable.  The faults
are device-level: queue contention on the card, memory squatting and a
storm of CUDA graph captures.

The names below load :mod:`tpuslo_torch.chaos.ici_contention` at first
use, not when the package is imported: the straggler's host processes
run that module as ``__main__`` (``python -m
tpuslo_torch.chaos.ici_contention --worker``).
"""

_EXPORTS = ("BarrierHostResult", "contention_injection", "run_contention",
            "run_straggler_injection")

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        from tpuslo_torch.chaos import ici_contention

        return getattr(ici_contention, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
