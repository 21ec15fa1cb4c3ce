"""Canonical content hashing for plans, pipelines, and statistics.

The serving layer caches optimized plans and compiled stage executables, so it
needs a *stable* identity for a plan: two structurally identical plans must
hash equal, and any change to an operator, expression, model weight, or
statistic must change the hash. This module feeds a canonical byte stream into
sha256:

  * scalars/strings/bytes — tagged by type, so ``1`` ≠ ``1.0`` ≠ ``"1"``;
  * numpy arrays — dtype + shape + raw bytes;
  * dataclasses (plan nodes, ``TableStats``, ``TreeEnsemble``, …) — class
    name + fields in declaration order;
  * ``Expr`` trees — hashed iteratively with per-node digest memoization
    (MLtoSQL emits tens of thousands of nodes; recursion would overflow, and
    shared sub-DAGs would blow up exponentially without the memo);
  * callables and other opaque objects — hashed by ``id()`` and recorded in
    ``pins``. Identity-hashed fingerprints are only valid while the object is
    alive, so any cache keyed on them must keep a strong reference to every
    pinned object (id reuse after GC would otherwise alias two different
    closures to one fingerprint).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np


def fingerprint(*objs: Any, pins: list | None = None) -> str:
    """Canonical sha256 hex digest of ``objs``.

    ``pins`` (if given) collects every object that was hashed by identity;
    the caller must keep those alive for as long as the fingerprint is used
    as a cache key.
    """
    h = hashlib.sha256()
    sink = pins if pins is not None else []
    for o in objs:
        _feed(h, o, sink)
    return h.hexdigest()


def node_fingerprint(
    node: Any, *, pins: list | None = None, exclude: tuple[str, ...] = ("child",)
) -> str:
    """Shallow canonical hash of one plan node (child subtrees excluded).

    The StageGraph hashes each stage as a *chain* — ``fp[i] = H(fp[i-1],
    ops[i])`` — so the per-node hash must cover the node's own content
    (expressions, pipeline weights, output names) without re-walking the
    subtree below it; upstream structure is already encoded by the chain.
    This is the prerequisite for per-stage artifact caching: a stage's
    fingerprint identifies "this operator slice of this plan" stably across
    plan objects and processes.
    """
    h = hashlib.sha256()
    sink = pins if pins is not None else []
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        h.update(b"C" + type(node).__name__.encode() + b"\x00")
        for f in dataclasses.fields(node):
            if f.name in exclude:
                continue
            h.update(b"f" + f.name.encode() + b"\x00")
            _feed(h, getattr(node, f.name), sink)
    else:
        _feed(h, node, sink)
    return h.hexdigest()


def _feed(h, obj: Any, pins: list) -> None:
    # Expr first: it is a dataclass, but deep chains need the iterative path
    from repro_torch.relational.expr import Expr

    if isinstance(obj, Expr):
        h.update(b"E")
        h.update(bytes.fromhex(_expr_digest(obj, pins)))
        return
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"B1" if obj else b"B0")
    elif isinstance(obj, (int, np.integer)):
        h.update(b"I" + str(int(obj)).encode())
    elif isinstance(obj, (float, np.floating)):
        h.update(b"F" + np.float64(obj).tobytes())
    elif isinstance(obj, str):
        h.update(b"S" + obj.encode() + b"\x00")
    elif isinstance(obj, bytes):
        h.update(b"Y" + obj + b"\x00")
    elif isinstance(obj, np.ndarray):
        h.update(b"A" + str(obj.dtype).encode() + str(obj.shape).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (list, tuple)):
        h.update(b"L" if isinstance(obj, list) else b"T")
        h.update(str(len(obj)).encode())
        for v in obj:
            _feed(h, v, pins)
    elif isinstance(obj, dict):
        h.update(b"D" + str(len(obj)).encode())
        # primitive keys sort by repr (stable, and preserves the historical
        # byte stream for every existing cache entry); rich keys sort by
        # their own canonical fingerprint — a repr can embed memory
        # addresses (`<Foo object at 0x...>`), which would silently make the
        # key *order* process-dependent even though each key hashes stably
        for k in sorted(obj, key=_dict_key):
            _feed(h, k, pins)
            _feed(h, obj[k], pins)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(b"C" + type(obj).__name__.encode() + b"\x00")
        for f in dataclasses.fields(obj):
            _feed(h, getattr(obj, f.name), pins)
    elif hasattr(obj, "__array__"):  # torch tensors and friends
        if hasattr(obj, "detach"):
            obj = obj.detach().cpu()
        _feed(h, np.asarray(obj), pins)
    else:
        # opaque objects carrying a canonical content token (e.g. MLtoDNN
        # TensorOp closures stamped by the tensor compiler) hash by that
        # token: content-stable across processes, nothing to pin
        token = getattr(obj, "__fingerprint_token__", None)
        if isinstance(token, str):
            h.update(b"K" + token.encode() + b"\x00")
            return
        # opaque (callables, foreign objects): identity hash — see module doc
        h.update(b"O" + str(id(obj)).encode())
        pins.append(obj)


_PRIMITIVE_KEYS = (type(None), bool, int, float, str, bytes)


def _dict_key(k: Any):
    if isinstance(k, _PRIMITIVE_KEYS):
        return (0, repr(k))
    return (1, fingerprint(k))


def _expr_digest(expr, pins: list) -> str:
    """Bottom-up digest of an Expr DAG (explicit stack, memoized by id)."""
    from repro_torch.relational.expr import Bin, Case, Col, Const, Param, Un

    memo: dict[int, str] = {}
    stack: list[tuple[Any, bool]] = [(expr, False)]
    while stack:
        node, visited = stack.pop()
        nid = id(node)
        if nid in memo:
            continue
        if isinstance(node, Col):
            memo[nid] = hashlib.sha256(b"Col" + node.name.encode()).hexdigest()
        elif isinstance(node, Param):
            # by *name* only: binding a different value must not change the
            # plan fingerprint (prepared queries re-bind without re-compiling)
            memo[nid] = hashlib.sha256(b"Param" + node.name.encode()).hexdigest()
        elif isinstance(node, Const):
            hh = hashlib.sha256(b"Const")
            _feed(hh, node.value, pins)
            memo[nid] = hh.hexdigest()
        elif visited:
            hh = hashlib.sha256()
            if isinstance(node, Bin):
                hh.update(b"Bin" + node.op.encode())
                hh.update(bytes.fromhex(memo[id(node.a)]))
                hh.update(bytes.fromhex(memo[id(node.b)]))
            elif isinstance(node, Un):
                hh.update(b"Un" + node.op.encode())
                hh.update(bytes.fromhex(memo[id(node.a)]))
            elif isinstance(node, Case):
                hh.update(b"Case")
                hh.update(bytes.fromhex(memo[id(node.cond)]))
                hh.update(bytes.fromhex(memo[id(node.then)]))
                hh.update(bytes.fromhex(memo[id(node.orelse)]))
            else:
                raise TypeError(type(node))
            memo[nid] = hh.hexdigest()
        else:
            stack.append((node, True))
            if isinstance(node, Bin):
                stack.extend([(node.a, False), (node.b, False)])
            elif isinstance(node, Un):
                stack.append((node.a, False))
            elif isinstance(node, Case):
                stack.extend(
                    [(node.cond, False), (node.then, False), (node.orelse, False)]
                )
            else:
                raise TypeError(type(node))
    return memo[id(expr)]
