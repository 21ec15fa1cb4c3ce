"""Typed option bundles for the session front door and the serving layer.

``connect(...)`` and ``PreparedQuery.serve(...)`` grew one keyword at a time
(``cache_dir``, ``cache_max_bytes``, ``verify``, ``max_latency_ms``,
``max_pending``, ``max_coalesce``, donation knobs) until every call site
carried a different subset of an undocumented sprawl. These dataclasses are
the consolidated, typed surface:

  * :class:`ConnectOptions` — everything a session is opened with beyond the
    tables and statistics themselves;
  * :class:`ServeOptions` — everything a served query's scheduler queue and
    execution path can be tuned with.

Both carry a canonical content fingerprint (:meth:`fingerprint`) so explain
output, logs, and cache keys can name a configuration stably, and both
``describe()`` themselves compactly (only non-default fields) for
``explain()``. The old keyword arguments keep working through shims that
emit :class:`DeprecationWarning` — see ``repro_torch.session.connect`` and
``PreparedQuery.serve``.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Union


def _deprecated_kwargs(context: str, replacement: str, kwargs: dict) -> None:
    """Warn once per call site about legacy keyword usage."""
    used = sorted(k for k, v in kwargs.items() if v is not None)
    if used:
        warnings.warn(
            f"{context}({', '.join(f'{k}=...' for k in used)}) is deprecated"
            f" — pass {replacement}({', '.join(used)}=...) instead",
            DeprecationWarning,
            stacklevel=3,
        )


@dataclass(frozen=True)
class ConnectOptions:
    """Session-wide configuration for :func:`repro_torch.session.connect`.

    ``optimizer`` sets the session-default
    :class:`~repro_torch.core.optimizer.OptimizerOptions`; ``strategy`` a
    statistics-driven runtime chooser. ``cache_dir``/``cache_max_bytes``
    root and bound the cross-process artifact store, ``verify`` the
    session-wide plan-verification mode, ``partition_cols`` the per-table
    partition columns for the data-induced statistics rule.
    """

    optimizer: Optional[Any] = None          # OptimizerOptions
    strategy: Any = None
    partition_cols: Optional[dict[str, str]] = None
    cache_dir: Optional[str] = None
    cache_max_bytes: Optional[int] = None
    verify: Union[str, bool, None] = None
    # fault-tolerance knobs: a seeded FaultPlan installed process-wide for
    # the session's lifetime (deterministic chaos drills; RAVEN_FAULTS is
    # the env equivalent), and the RollbackPolicy the model registry's
    # rollback guard enforces on live versions after a cutover
    faults: Optional[Any] = None             # a FaultPlan
    rollback: Optional[Any] = None           # a RollbackPolicy

    @classmethod
    def resolve(
        cls,
        options: Any = None,
        *,
        partition_cols: Optional[dict[str, str]] = None,
        strategy: Any = None,
        cache_dir: Optional[str] = None,
        cache_max_bytes: Optional[int] = None,
        verify: Union[str, bool, None] = None,
        _context: str = "connect",
    ) -> "ConnectOptions":
        """Merge the typed bundle with legacy keywords (shim path).

        ``options`` may be a :class:`ConnectOptions`, a bare
        :class:`~repro_torch.core.optimizer.OptimizerOptions` (accepted directly —
        optimizer configuration is orthogonal, not deprecated), or None.
        Legacy ``cache_dir``/``cache_max_bytes``/``verify`` keywords emit a
        :class:`DeprecationWarning` and are merged in; an explicit keyword
        never silently overrides a conflicting field already set on the
        bundle — that raises, because two different answers for the same
        knob is a caller bug, not a preference.
        """
        from repro_torch.core.optimizer import OptimizerOptions

        if isinstance(options, ConnectOptions):
            base = options
        elif isinstance(options, OptimizerOptions):
            base = cls(optimizer=options)
        elif options is None:
            base = cls()
        else:
            raise TypeError(
                f"options must be ConnectOptions or OptimizerOptions, "
                f"got {type(options).__name__}"
            )
        _deprecated_kwargs(
            _context, "ConnectOptions",
            {"cache_dir": cache_dir, "cache_max_bytes": cache_max_bytes,
             "verify": verify},
        )
        merged = {}
        for name, value in (
            ("partition_cols", partition_cols), ("strategy", strategy),
            ("cache_dir", cache_dir), ("cache_max_bytes", cache_max_bytes),
            ("verify", verify),
        ):
            if value is None:
                continue
            current = getattr(base, name)
            if current is not None and current != value:
                raise ValueError(
                    f"{_context}: {name} given both as a keyword ({value!r}) "
                    f"and on ConnectOptions ({current!r})"
                )
            merged[name] = value
        return dataclasses.replace(base, **merged) if merged else base

    def fingerprint(self) -> str:
        """Canonical content hash of this configuration.

        Content-stable whenever every field is (dataclasses, scalars,
        dicts); a strategy object without canonical content hashes by
        identity, which :meth:`content_stable` reports."""
        from repro_torch.core.fingerprint import fingerprint

        return fingerprint("connect-options", *self._tokens())

    @property
    def content_stable(self) -> bool:
        """True when the fingerprint is valid across processes (no field
        hashed by object identity)."""
        from repro_torch.core.fingerprint import fingerprint

        pins: list = []
        fingerprint("connect-options", *self._tokens(), pins=pins)
        return not pins

    def _tokens(self) -> tuple:
        return (
            self.optimizer, self.strategy, self.partition_cols,
            self.cache_dir, self.cache_max_bytes, self.verify,
            self.faults, self.rollback,
        )

    def describe(self) -> str:
        """Compact non-default-fields rendering for ``explain()``."""
        return _describe(self, "ConnectOptions")


@dataclass(frozen=True)
class ServeOptions:
    """Per-served-query configuration for :meth:`PreparedQuery.serve`.

    ``max_latency_ms`` is the queue's flush deadline (EDF across queries,
    and serving starts the background pump), ``max_pending`` its
    backpressure bound, ``max_coalesce`` the widest row group one dispatch
    may coalesce. ``donate=False`` keeps this query's padded entry buffers
    un-donated even on backends that support aliasing (useful when the
    caller retains references into the submitted arrays).
    """

    max_latency_ms: Optional[float] = None
    max_pending: Optional[int] = None
    max_coalesce: Optional[int] = None
    donate: bool = True
    # fault tolerance: the queue's transient-failure RetryPolicy (None uses
    # the scheduler default) and the consecutive-failure count that trips
    # this query's circuit breaker onto the kernel-free fallback plan
    retry: Optional[Any] = None              # a RetryPolicy
    breaker_threshold: Optional[int] = None

    @classmethod
    def resolve(
        cls,
        options: Optional["ServeOptions"] = None,
        *,
        max_latency_ms: Optional[float] = None,
        max_pending: Optional[int] = None,
        max_coalesce: Optional[int] = None,
        _context: str = "serve",
    ) -> "ServeOptions":
        """Merge a typed bundle with legacy keywords (shim path); legacy
        keywords warn, and a keyword conflicting with the bundle raises."""
        if options is not None and not isinstance(options, ServeOptions):
            raise TypeError(
                f"options must be ServeOptions, got {type(options).__name__}"
            )
        base = options or cls()
        _deprecated_kwargs(
            _context, "ServeOptions",
            {"max_latency_ms": max_latency_ms, "max_pending": max_pending,
             "max_coalesce": max_coalesce},
        )
        merged = {}
        for name, value in (
            ("max_latency_ms", max_latency_ms), ("max_pending", max_pending),
            ("max_coalesce", max_coalesce),
        ):
            if value is None:
                continue
            current = getattr(base, name)
            if current is not None and current != value:
                raise ValueError(
                    f"{_context}: {name} given both as a keyword ({value!r}) "
                    f"and on ServeOptions ({current!r})"
                )
            merged[name] = value
        return dataclasses.replace(base, **merged) if merged else base

    def fingerprint(self) -> str:
        """Canonical content hash (all fields are scalars: always stable)."""
        from repro_torch.core.fingerprint import fingerprint

        return fingerprint(
            "serve-options", self.max_latency_ms, self.max_pending,
            self.max_coalesce, self.donate, self.retry,
            self.breaker_threshold,
        )

    def describe(self) -> str:
        """Compact non-default-fields rendering for ``explain()``."""
        return _describe(self, "ServeOptions")


def _describe(opts: Any, label: str) -> str:
    shown = []
    for f in dataclasses.fields(opts):
        v = getattr(opts, f.name)
        if v != f.default:
            shown.append(f"{f.name}={v!r}")
    body = ", ".join(shown) if shown else "defaults"
    return f"{label}({body})  fingerprint={opts.fingerprint()[:16]}…"
