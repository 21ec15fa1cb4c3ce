"""Typed, message-bearing errors raised by the SQL frontend and the engine.

The parser raises these instead of leaking raw ``KeyError``/``IndexError``
from internal dict lookups, so callers can catch one family (``RavenError``)
or a specific failure mode. ``SQLSyntaxError`` also subclasses
:class:`SyntaxError`.
"""
from __future__ import annotations


class RavenError(Exception):
    """Base class for all prediction-query API errors."""


class SQLSyntaxError(RavenError, SyntaxError):
    """Malformed query text (including a malformed PREDICT clause)."""


class UnknownModelError(RavenError):
    """PREDICT references a model name absent from the registry."""


class UnknownTableError(RavenError):
    """Query references a table absent from the database."""


class UnknownColumnError(RavenError):
    """Predicate or join key references a column no table provides."""


class UnboundParameterError(RavenError):
    """A ``:param`` placeholder was left unbound at execute time."""
