"""Scalar expression trees over columns — the engine's "SQL expressions".

MLtoSQL compiles models into these (trees → nested ``Case``; linear models →
mul/add chains), so expression evaluation must scale to tens of thousands of
nodes without hitting Python recursion limits: evaluation is an explicit-stack
post-order walk producing torch ops on the columns' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Union

import torch

Num = Union[int, float, bool]


class Expr:
    __slots__ = ()

    # sugar for rule-writers / tests
    def __add__(self, o): return Bin("add", self, _wrap(o))
    def __sub__(self, o): return Bin("sub", self, _wrap(o))
    def __mul__(self, o): return Bin("mul", self, _wrap(o))
    def __le__(self, o): return Bin("le", self, _wrap(o))
    def __lt__(self, o): return Bin("lt", self, _wrap(o))
    def __ge__(self, o): return Bin("ge", self, _wrap(o))
    def __gt__(self, o): return Bin("gt", self, _wrap(o))

    def eq(self, o): return Bin("eq", self, _wrap(o))
    def and_(self, o): return Bin("and", self, _wrap(o))
    def or_(self, o): return Bin("or", self, _wrap(o))


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Const(v)


@dataclass(frozen=True)
class Col(Expr):
    name: str


@dataclass(frozen=True)
class Const(Expr):
    value: Any


@dataclass(frozen=True)
class Param(Expr):
    """Named query parameter (a ``:name`` placeholder).

    Hashes by *name*, not value: the bound value rides into the compiled
    program through the execution environment (a 0-d tensor), so re-binding
    a parameter changes neither the plan fingerprint nor the compiled plan.
    """

    name: str


@dataclass(frozen=True)
class Bin(Expr):
    op: str  # add sub mul div le lt ge gt eq ne and or min max
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Un(Expr):
    """Unary scalar function (SQL's EXP/SQRT/... family)."""

    op: str  # neg abs exp log sqrt sigmoid
    a: Expr


@dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN cond THEN then ELSE orelse END."""

    cond: Expr
    then: Expr
    orelse: Expr


_UN = {
    "neg": torch.neg,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    # inverse sigmoid, clipped like the optimizer's static threshold rewrite
    # so prob-space parameters survive the logit-space filter rewrite
    "logit": lambda x: (lambda p: torch.log(p / (1.0 - p)))(
        torch.clamp(x, 1e-9, 1.0 - 1e-9)
    ),
}

_BIN = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "le": torch.le,
    "lt": torch.lt,
    "ge": torch.ge,
    "gt": torch.gt,
    "eq": torch.eq,
    "ne": torch.ne,
    "and": torch.logical_and,
    "or": torch.logical_or,
    "min": torch.minimum,
    "max": torch.maximum,
}


def eval_expr(
    expr: Expr,
    env: dict[str, torch.Tensor],
    params: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Iterative post-order evaluation (no recursion limit).

    Constants become 0-d tensors on the columns' device; like JAX's weakly
    typed scalars, a 0-d operand does not widen a column's dtype (an int32
    column compared with ``1`` stays an int32 comparison, ``x > 0.0`` on an
    f32 column stays f32)."""
    device = next(iter(env.values())).device if env else None
    out: dict[int, torch.Tensor] = {}
    stack: list[tuple[Expr, bool]] = [(expr, False)]
    while stack:
        node, visited = stack.pop()
        nid = id(node)
        if nid in out:
            continue
        if isinstance(node, Col):
            out[nid] = env[node.name]
        elif isinstance(node, Param):
            if params is None or node.name not in params:
                from repro_torch.errors import UnboundParameterError

                raise UnboundParameterError(
                    f"parameter :{node.name} is unbound — pass it via "
                    f"params={{'{node.name}': value}}"
                )
            out[nid] = torch.as_tensor(params[node.name], device=device)
        elif isinstance(node, Const):
            out[nid] = torch.as_tensor(node.value, device=device)
        elif visited:
            if isinstance(node, Bin):
                out[nid] = _BIN[node.op](out[id(node.a)], out[id(node.b)])
            elif isinstance(node, Un):
                out[nid] = _UN[node.op](out[id(node.a)])
            else:  # Case
                out[nid] = torch.where(
                    out[id(node.cond)].to(torch.bool),
                    out[id(node.then)], out[id(node.orelse)],
                )
        else:
            stack.append((node, True))
            if isinstance(node, Bin):
                stack.append((node.a, False))
                stack.append((node.b, False))
            elif isinstance(node, Un):
                stack.append((node.a, False))
            elif isinstance(node, Case):
                stack.append((node.cond, False))
                stack.append((node.then, False))
                stack.append((node.orelse, False))
            else:
                raise TypeError(type(node))
    return out[id(expr)]


def expr_size(expr: Expr) -> int:
    """Node count (shared subtrees counted once) — drives the strategy stats."""
    seen: set[int] = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, Bin):
            stack.extend([node.a, node.b])
        elif isinstance(node, Un):
            stack.append(node.a)
        elif isinstance(node, Case):
            stack.extend([node.cond, node.then, node.orelse])
    return len(seen)


def columns_of(expr: Expr) -> set[str]:
    cols: set[str] = set()
    seen: set[int] = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, Col):
            cols.add(node.name)
        elif isinstance(node, Bin):
            stack.extend([node.a, node.b])
        elif isinstance(node, Un):
            stack.append(node.a)
        elif isinstance(node, Case):
            stack.extend([node.cond, node.then, node.orelse])
    return cols


def params_of(expr: Expr) -> set[str]:
    """Names of all :class:`Param` placeholders reachable from ``expr``."""
    names: set[str] = set()
    seen: set[int] = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, Param):
            names.add(node.name)
        elif isinstance(node, Bin):
            stack.extend([node.a, node.b])
        elif isinstance(node, Un):
            stack.append(node.a)
        elif isinstance(node, Case):
            stack.extend([node.cond, node.then, node.orelse])
    return names


_OP_SYMBOL = {
    "add": "+", "sub": "-", "mul": "*", "div": "/",
    "le": "<=", "lt": "<", "ge": ">=", "gt": ">",
    "eq": "=", "ne": "<>", "and": "AND", "or": "OR",
    "min": "MIN", "max": "MAX",
}


def format_expr(expr: Expr, max_nodes: int = 24) -> str:
    """Compact SQL-ish rendering for EXPLAIN output.

    MLtoSQL emits expressions with tens of thousands of nodes; those are
    summarized as ``<N-node expr over (cols)>`` instead of being printed
    (also keeps the recursive pretty-printer off the deep trees).
    """
    n = expr_size(expr)
    if n > max_nodes:
        cols = sorted(columns_of(expr))
        more = "" if len(cols) <= 6 else ", …"
        return f"<{n}-node expr over ({', '.join(cols[:6])}{more})>"

    def fmt(e: Expr) -> str:
        if isinstance(e, Col):
            return e.name
        if isinstance(e, Param):
            return f":{e.name}"
        if isinstance(e, Const):
            v = e.value
            return f"{v:g}" if isinstance(v, float) else repr(v)
        if isinstance(e, Bin):
            sym = _OP_SYMBOL.get(e.op, e.op)
            if sym in ("MIN", "MAX"):
                return f"{sym}({fmt(e.a)}, {fmt(e.b)})"
            return f"({fmt(e.a)} {sym} {fmt(e.b)})"
        if isinstance(e, Un):
            return f"{e.op}({fmt(e.a)})"
        if isinstance(e, Case):
            return (
                f"CASE WHEN {fmt(e.cond)} THEN {fmt(e.then)} "
                f"ELSE {fmt(e.orelse)} END"
            )
        raise TypeError(type(e))

    return fmt(expr)
