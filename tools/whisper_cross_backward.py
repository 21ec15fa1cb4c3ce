"""Both packages' chunked attention backward on one whisper-small cross
attention dumped from the card, on the CPU:

    PYTHONPATH=src python3 tools/whisper_cross_backward.py OUT_DIR/whisper_cross_layer<L>.npz

The dump (``tools/attention_train_probe.py whisper OUT_DIR``) holds one decoder
layer's cross-attention query, keys, values and output gradient, and the
inputs of its projections (``hn``, the encoder's output), from the bf16
training step and from the float32 step on the same weights, after
whisper-small's 4 training steps. For each package (the reference's
``attention_chunked`` under ``jax.vjp``, the port's ``attention_train``
under autograd) it runs the backward on the bf16 inputs and on the float32
inputs, and prints each bf16 gradient's error against the same package's
float32 gradient, ||g16 - g32|| / ||g32||: the query's and keys' gradients
and the layer's slices of the weight and bias gradients they give
(``hn^T dq``, ``sum dq``, ``enc^T dk``, ``sum dk``, summed in float32 here);
then against the float32 backward on the bf16 step's own inputs, upcast,
which leaves the backward's rounding alone. The two packages' float32
gradients are printed against each other too. ``bk_col``'s gradient is
zero in exact arithmetic (a bias on every key shifts a query's scores
alike), so its ratio measures float32 noise.
"""
from __future__ import annotations

import json
import sys

import numpy as np


def _load(path: str) -> dict:
    import torch

    raw = np.load(path)
    out = {}
    for k in raw.files:
        a = raw[k]
        out[k] = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                  if a.dtype == np.uint16 else torch.from_numpy(a))
    return out


def port_grads(q, k, v, dO) -> tuple:
    import torch

    from repro_torch.models import layers as L

    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    L.attention_train(q, k, v, causal=False).backward(dO)
    return q.grad, k.grad, v.grad


def reference_grads(q, k, v, dO) -> tuple:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import layers as JL

    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32

    def j(t):
        return jnp.asarray(t.float().numpy(), dt)

    _, vjp = jax.vjp(lambda a, b, c: JL.attention_chunked(a, b, c, causal=False),
                     j(q), j(k), j(v))
    return tuple(torch.from_numpy(np.array(g, np.float32)) for g in vjp(j(dO)))


def leaf_grads(dq, dk, hn, enc) -> dict:
    """The layer's slices of the cross query's and keys' weight and bias
    gradients, in float32."""
    rows = dq.shape[0] * dq.shape[1]
    dq, dk = dq.float().reshape(rows, -1), dk.float().reshape(-1, dk.shape[2] * dk.shape[3])
    hn, enc = hn.float().reshape(rows, -1), enc.float().reshape(dk.shape[0], -1)
    return {"dq": dq, "dk": dk, "wq_col": hn.T @ dq, "bq_col": dq.sum(0),
            "wk_col": enc.T @ dk, "bk_col": dk.sum(0)}


def rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b))


def main(path: str) -> dict:
    d = _load(path)
    out = {"layer": int(d["layer"])}
    per = {}
    for name, grads in (("reference", reference_grads), ("port", port_grads)):
        by_dtype = {}
        for dtype in ("bfloat16", "float32"):
            q, k, v, dO = (d[f"{n}_{dtype}"] for n in ("q", "k", "v", "dO"))
            dq, dk, _ = grads(q, k, v, dO)
            by_dtype[dtype] = leaf_grads(dq, dk, d[f"hn_{dtype}"], d[f"enc_{dtype}"])
        q, k, v, dO = (d[f"{n}_bfloat16"].float() for n in ("q", "k", "v", "dO"))
        dq, dk, _ = grads(q, k, v, dO)
        upcast = leaf_grads(dq, dk, d["hn_bfloat16"], d["enc_bfloat16"])
        per[name] = by_dtype
        out[f"{name} bf16 vs its float32"] = {
            k: rel(by_dtype["bfloat16"][k], by_dtype["float32"][k]) for k in by_dtype["float32"]}
        out[f"{name} bf16 vs float32 on the bf16 inputs"] = {
            k: rel(by_dtype["bfloat16"][k], upcast[k]) for k in upcast}
    out["port float32 vs reference float32"] = {
        k: rel(per["port"]["float32"][k], per["reference"]["float32"][k])
        for k in per["port"]["float32"]}
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(1)
    print(json.dumps(main(sys.argv[1]), indent=1))
