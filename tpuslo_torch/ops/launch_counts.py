"""The port's launch counters as one list, so that a CUDA graph can
credit its replays.

Each kernel wrapper counts the calls that launched its kernel in a
plain integer attribute (``paged_decode_attention.launches`` ...), and
the model counts the layers its cached passes ran on the card in
:data:`cached_layers`, which K2's lanes are held to.  A
replay of a captured graph launches what the capture recorded without
running the wrappers: :class:`~tpuslo_torch.models.graphs.GraphedDispatch`
takes the counters' :func:`snapshot` around the capture, puts them back
(recording is not launching) and credits the difference at every
replay, so the counters keep telling what ran on the card.
"""

from __future__ import annotations

import sys

_COUNTERS: list[tuple[object, str]] = []


def register(owner: object, *attrs: str) -> None:
    """Add ``owner.<attr>`` for each attr (an int counter) to the list."""
    for attr in attrs:
        if (owner, attr) not in _COUNTERS:
            _COUNTERS.append((owner, attr))


def snapshot() -> dict[tuple[int, str], int]:
    return {(id(owner), attr): getattr(owner, attr) for owner, attr in _COUNTERS}


def since(before: dict[tuple[int, str], int]) -> list[tuple[object, str, int]]:
    """(owner, attr, increment) of every counter that moved since ``before``."""
    moved = []
    for owner, attr in _COUNTERS:
        d = getattr(owner, attr) - before.get((id(owner), attr), 0)
        if d:
            moved.append((owner, attr, d))
    return moved


def add(moved: list[tuple[object, str, int]], sign: int = 1) -> None:
    """Add (or with ``sign`` -1 take back) the increments of :func:`since`."""
    for owner, attr, d in moved:
        setattr(owner, attr, getattr(owner, attr) + sign * d)


#: Layers of the cached passes (decode, verify, draft) the card has run,
#: each reading its dense cache as K2's lanes.
cached_layers = 0
register(sys.modules[__name__], "cached_layers")
