"""PREDICT-statement SQL frontend (paper §6 syntax, TVF form).

Supported grammar (enough for the paper's query shapes — scan or multi-way
FK join, a PREDICT TVF, conjunctive predicates over inputs and outputs,
aggregates or column select):

    SELECT <item [, item ...]>
    FROM PREDICT(model = '<path-or-name>',
                 data = <table> [JOIN <table> ON <col> = <col>]*) AS <alias>
    [WHERE <col|alias.col> <op> <literal|:param> [AND ...]]

    item := COUNT(*) | SUM(col) | AVG(col) | MIN(col) | MAX(col)
          | col | alias.col | *
    op   := = | <> | != | < | <= | > | >=

``:name`` placeholders become :class:`~repro_torch.relational.expr.Param` slots in
the IR: they hash by name (not value), so a prepared plan re-binds thresholds
without re-optimizing or changing its fingerprint.

Parsing is split in two stages shared with the session API's fluent builder:
``parse_spec`` produces a neutral :class:`QuerySpec`, and
``build_prediction_query`` lowers a spec to the unified IR — the builder
assembles the same spec, so both front doors yield fingerprint-identical
:class:`repro_torch.core.ir.PredictionQuery` instances.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.core.ir import (
    LAggregate,
    LFilter,
    LJoin,
    LPredict,
    LScan,
    PredictionQuery,
    TableStats,
)
from repro_torch.errors import (
    SQLSyntaxError,
    UnknownColumnError,
    UnknownModelError,
    UnknownTableError,
)
from repro_torch.relational.expr import Bin, Col, Const, Expr, Param

_TOKEN = re.compile(
    r"\s*(?:(?P<str>'[^']*')|(?P<num>-?\d+\.?\d*(?:[eE][-+]?\d+)?)"
    r"|(?P<param>:[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\.)"
    r"|(?P<word>[A-Za-z_][A-Za-z_0-9]*))"
)

_OPMAP = {
    "=": "eq", "<": "lt", "<=": "le", ">": "gt", ">=": "ge",
    "<>": "ne", "!=": "ne",
}

_AGGMAP = {
    "COUNT": "count", "SUM": "sum", "AVG": "mean",
    "MIN": "min", "MAX": "max",
}


def canonical_op(op: str) -> str:
    """Normalize a comparison operator (symbol or canonical name)."""
    if op in _OPMAP:
        return _OPMAP[op]
    if op in _OPMAP.values():
        return op
    raise SQLSyntaxError(
        f"unknown comparison operator {op!r} — expected one of "
        f"{sorted(_OPMAP)} or {sorted(set(_OPMAP.values()))}"
    )


def _tokenize(sql: str) -> list[str]:
    tokens, pos = [], 0
    while pos < len(sql):
        m = _TOKEN.match(sql, pos)
        if not m:
            if sql[pos:].strip() == "":
                break
            raise SQLSyntaxError(f"bad token at: {sql[pos:pos+20]!r}")
        tokens.append(m.group(0).strip())
        pos = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def next(self) -> str:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, word: str) -> str:
        t = self.next()
        if t.upper() != word.upper():
            raise SQLSyntaxError(
                f"expected {word}, got {t!r}" if t else f"expected {word}, "
                "got end of query"
            )
        return t


# ---------------------------------------------------------------------------
# Stage 1: text -> QuerySpec (shared target with the fluent builder)
# ---------------------------------------------------------------------------


@dataclass
class QuerySpec:
    """Neutral description of one prediction query.

    Both front doors (SQL text and the fluent builder) lower to this, and
    :func:`build_prediction_query` is the single spec -> IR path — which is
    what makes their IR (and hence plan fingerprints) identical.
    """

    items: list[tuple[str, str]] = field(default_factory=list)  # (kind, arg)
    model: str | None = None
    base: str | None = None
    joins: list[tuple[str, str, str]] = field(default_factory=list)
    preds: list[tuple[str, str, Expr]] = field(default_factory=list)


def parse_select_items(text_or_parser) -> list[tuple[str, str]]:
    """Parse a SELECT item list: ``COUNT(*), AVG(score), col, t.col, *``."""
    p = (
        text_or_parser
        if isinstance(text_or_parser, _Parser)
        else _Parser(_tokenize(text_or_parser))
    )
    items: list[tuple[str, str]] = []
    while True:
        t = p.next()
        if not t:
            raise SQLSyntaxError("expected a select item, got end of input")
        u = t.upper()
        if u in _AGGMAP:
            p.expect("(")
            arg = p.next()
            p.expect(")")
            items.append((_AGGMAP[u], arg))
        elif t == "*":
            items.append(("star", "*"))
        else:
            # col or alias.col
            if p.peek() == ".":
                p.next()
                col = p.next()
                items.append(("col", col))
            else:
                items.append(("col", t))
        if p.peek() == ",":
            p.next()
            continue
        break
    return items


def parse_condition(text_or_parser, alias: str | None = None) -> tuple[str, str, Expr]:
    """Parse one ``col <op> literal|:param`` comparison."""
    p = (
        text_or_parser
        if isinstance(text_or_parser, _Parser)
        else _Parser(_tokenize(text_or_parser))
    )
    col = _qualcol(p, alias)
    op = p.next()
    if op not in _OPMAP:
        raise SQLSyntaxError(f"expected a comparison operator, got {op!r}")
    lit = p.next()
    if not lit:
        raise SQLSyntaxError(f"expected a literal or :param after {op!r}")
    return col, _OPMAP[op], _value_expr(lit)


def _value_expr(lit: str) -> Expr:
    if lit.startswith(":"):
        return Param(lit[1:])
    if lit.startswith("'"):
        return Const(lit.strip("'"))
    try:
        return Const(float(lit))
    except ValueError:
        raise SQLSyntaxError(
            f"expected a literal or :param, got {lit!r}"
        ) from None


def parse_spec(sql: str) -> QuerySpec:
    """Parse PREDICT-statement SQL text into a :class:`QuerySpec`."""
    p = _Parser(_tokenize(sql))
    p.expect("SELECT")
    spec = QuerySpec(items=parse_select_items(p))

    p.expect("FROM")
    p.expect("PREDICT")
    p.expect("(")
    p.expect("model")
    p.expect("=")
    spec.model = p.next().strip("'")
    p.expect(",")
    p.expect("data")
    p.expect("=")
    spec.base = p.next()
    if not spec.base:
        raise SQLSyntaxError("PREDICT clause is missing the data= table")
    while p.peek().upper() == "JOIN":
        p.next()
        dim = p.next()
        p.expect("ON")
        a = _qualcol(p)
        p.expect("=")
        b = _qualcol(p)
        spec.joins.append((dim, a, b))
    p.expect(")")
    alias = None
    if p.peek().upper() == "AS":
        p.next()
        alias = p.next()

    if p.peek().upper() == "WHERE":
        p.next()
        while True:
            spec.preds.append(parse_condition(p, alias))
            if p.peek().upper() == "AND":
                p.next()
                continue
            break
    if p.peek():
        raise SQLSyntaxError(f"unexpected trailing token {p.peek()!r}")
    return spec


def _qualcol(p: _Parser, alias: str | None = None) -> str:
    a = p.next()
    if p.peek() == ".":
        p.next()
        return p.next()
    return a


# ---------------------------------------------------------------------------
# Stage 2: QuerySpec -> unified IR
# ---------------------------------------------------------------------------


def build_prediction_query(
    spec: QuerySpec,
    models: dict,
    database: dict,
    stats: dict[str, TableStats] | None = None,
) -> PredictionQuery:
    """Lower a :class:`QuerySpec` to a :class:`PredictionQuery` (unified IR)."""
    if spec.model is None:
        raise SQLSyntaxError("query has no PREDICT(model=..., data=...) clause")
    if spec.base is None:
        raise SQLSyntaxError("PREDICT clause names no data= table")
    if spec.model not in models:
        raise UnknownModelError(
            f"unknown model '{spec.model}' — registered models: "
            f"{sorted(map(str, models)) or '(none)'}"
        )
    if spec.base not in database:
        raise UnknownTableError(
            f"unknown table '{spec.base}' — known tables: {sorted(database)}"
        )

    pipeline = models[spec.model]
    if isinstance(pipeline, str):
        from repro_torch.ml.pipeline import load_pipeline

        pipeline = load_pipeline(pipeline)
    out_names = ["score", "pred"][: len(pipeline.outputs)]

    known_cols = set(database[spec.base])
    plan = LScan(spec.base, list(database[spec.base].keys()))
    for dim, a, b in spec.joins:
        if dim not in database:
            raise UnknownTableError(
                f"unknown join table '{dim}' — known tables: {sorted(database)}"
            )
        if b in database[dim]:
            fact_key, dim_key = a, b
        elif a in database[dim]:
            fact_key, dim_key = b, a
        else:
            raise UnknownColumnError(
                f"join key {a!r}={b!r}: neither side is a column of '{dim}'"
            )
        dim_cols = [c for c in database[dim] if c != dim_key]
        known_cols |= set(database[dim])
        plan = LJoin(plan, dim, fact_key, dim_key, dim_cols)

    for col, _op, _v in spec.preds:
        if col not in known_cols and col not in out_names:
            raise UnknownColumnError(
                f"predicate column '{col}' is neither a table column nor a "
                f"model output {out_names}"
            )

    input_preds = [x for x in spec.preds if x[0] not in out_names]
    output_preds = [x for x in spec.preds if x[0] in out_names]
    for col, op, v in input_preds:
        plan = LFilter(plan, Bin(op, Col(col), v))
    plan = LPredict(plan, pipeline.copy(), out_names)
    for col, op, v in output_preds:
        plan = LFilter(plan, Bin(op, Col(col), v))

    aggs = [
        (f"{kind}_{arg if arg != '*' else 'rows'}", kind, arg)
        for kind, arg in spec.items
        if kind in ("count", "sum", "mean", "min", "max")
    ]
    if aggs:
        # COUNT(*) needs a concrete column: use the first predict output
        aggs = [
            (name, kind, out_names[-1] if arg == "*" else arg)
            for (name, kind, arg) in aggs
        ]
        plan = LAggregate(plan, aggs)

    return PredictionQuery(plan=plan, stats=stats or {})


def parse_prediction_query(
    sql: str,
    models: dict,
    database: dict,
    stats: dict[str, TableStats] | None = None,
    fact: str | None = None,
) -> PredictionQuery:
    """One-call convenience: SQL text -> unified IR."""
    return build_prediction_query(parse_spec(sql), models, database, stats)
