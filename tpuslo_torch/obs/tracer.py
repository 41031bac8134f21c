"""The null tracer cycle (the port's own copy of the disabled-tracer
objects of ``tpuslo/obs/tracer.py``).

The front door's ``step`` runs its stages under a cycle object; without
a tracer that object is :data:`_NULL_CYCLE`, whose stages record
nothing.  ``self_tracer=`` stays a duck-typed argument of the engines:
any object with ``cycle(name, **attrs)`` returning a context manager
whose value has ``stage(name)`` works.  The recording ``SelfTracer`` is
not ported yet.
"""

from __future__ import annotations

from typing import Any


class _NullSpan:
    """Attribute sink for the disabled tracer: every call is a no-op."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullStageCM:
    """Shared no-op stage context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_STAGE_CM = _NullStageCM()


class _NullCycle:
    """Disabled-tracer cycle: ``stage`` costs well under a microsecond,
    nothing is recorded.  Shared instance — it holds no state."""

    __slots__ = ()

    trace_id = ""
    root = None
    error = False

    def stage(self, name: str, **attrs: Any) -> _NullStageCM:
        return _NULL_STAGE_CM

    def mark_keep(self) -> None:
        pass


_NULL_CYCLE = _NullCycle()
