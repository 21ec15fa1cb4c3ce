"""Runtime-assertion mode: verifier invariants as cheap serving-path checks.

``RAVEN_ANALYSIS_ASSERTS=1`` arms :func:`runtime_assert` call sites placed
at the scheduler and query-server hot spots (request routing, group
dispatch, result finish). They are read-at-call-time so a test can flip the
env var without rebuilding anything, and they are ordinary ``if`` checks —
never ``assert`` statements — so ``python -O`` cannot silently strip them.
Disabled (the default), each site costs one dict lookup.
"""
from __future__ import annotations

import os


class RuntimeInvariantError(AssertionError):
    """A serving-path invariant failed under RAVEN_ANALYSIS_ASSERTS=1."""


def asserts_enabled() -> bool:
    return os.environ.get("RAVEN_ANALYSIS_ASSERTS", "") not in (
        "", "0", "false", "off",
    )


def runtime_assert(cond: bool, message: str) -> None:
    """Raise :class:`RuntimeInvariantError` when armed and ``cond`` fails.

    Call sites should guard expensive condition construction with
    :func:`asserts_enabled` themselves; passing a cheap boolean here is
    fine unguarded.
    """
    if not cond and asserts_enabled():
        raise RuntimeInvariantError(f"RAVEN_ANALYSIS_ASSERTS: {message}")
