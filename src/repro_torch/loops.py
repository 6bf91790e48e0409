"""A counted loop: the port's counterpart of ``lax.scan``.

Where the JAX package scans (the pattern groups, the microbatches, the
sLSTM's steps, the mLSTM's chunks, whisper's layers, chunked attention's
chunks), the port runs a Python loop through :func:`scan`.  Outside a
cost count it is exactly that loop — each ``x`` of ``xs`` in turn, the
body's ``y`` collected in a list — and computes what the loop computes,
with no op of its own.

Under a loop-aware cost count (``launch/hlo_analysis.CostMode``, the
dry-run's counter) the count runs the body only until two consecutive
trips count alike and adds the last trip's count once a skipped trip —
a body times its trips, as the JAX package's analysis multiplies a
``while`` body by its trip count.  The loop then returns the carry of
the trips it ran, and each skipped trip's ``y`` is an uninitialized
tensor of the last ``y`` 's shape: what the count reads (shapes, dtypes,
bytes) is the whole loop's, the values are not.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["scan"]


def _counter():
    """The innermost active dispatch mode that counts loops (its
    ``counts_loops`` is true; it has a ``count_scan`` method), or
    None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_loops", False):
            return mode
    return None


def scan(name: str, body: Callable[[Any, Any], Tuple[Any, Any]], carry,
         xs: Sequence, unroll: bool = False) -> Tuple[Any, List]:
    """``carry, y = body(carry, x)`` for each ``x`` of ``xs`` in order ->
    ``(carry, [y, ...])``, one ``y`` a trip.

    ``name`` names the loop's site in a count's record.  A loop of one
    trip, or one with ``unroll`` (the counterpart of the JAX package's
    ``scan_layers=False``), is a plain loop under a count too: a count
    reads every trip and records no loop."""
    xs = list(xs)
    counter = None if unroll or len(xs) < 2 else _counter()
    if counter is not None:
        return counter.count_scan(name, body, carry, xs)
    ys = []
    for x in xs:
        carry, y = body(carry, x)
        ys.append(y)
    return carry, ys
