"""One reduced zoo config built in both packages on the same weights, and
a prefill plus decode steps driven through both: the harness of
``tests/test_torch_vlm.py`` and ``tests/test_torch_encdec.py``.

The reference's ``model.init`` draws the weights and ``params_from_jax``
carries them over; inputs are numpy arrays handed to both packages.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax


def pair_of_models(name: str, dtype: str = "float32", seed: int = 0, **replace):
    """(reference model, its params, port model, the same params);
    ``replace`` changes both configs alike."""
    import dataclasses

    jmodel = jbuild_model(dataclasses.replace(jreduced_config(name, dtype=dtype), **replace))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(dataclasses.replace(reduced_config(name, dtype=dtype), **replace))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def close(got: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def run_both(pair, batch: dict, *, cache_len: int, lengths: np.ndarray, steps: int,
             atol: float):
    """Prefill ``batch`` (numpy arrays) in both packages with ``cache_len``
    rows of self cache, then ``steps`` greedy decode steps from
    ``lengths`` (the reference's tokens fed to both), holding the logits
    and every cache after each within ``atol``. Returns the port's last
    logits and caches."""
    jmodel, jparams, model, params = pair
    jl, jc = jmodel.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                            cache_len=cache_len)
    tl, tc = model.prefill(params, {k: torch.tensor(v) for k, v in batch.items()},
                           cache_len=cache_len)
    assert tl.shape == jl.shape and len(tc) == len(jc)
    close(tl, jl, atol)
    for a, b in zip(tc, jc):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
        close(a, b, atol)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        step = {"tokens": tok, "lengths": lengths.astype(np.int32)}
        jl, jc = jmodel.decode(jparams, {k: jnp.asarray(v) for k, v in step.items()}, jc)
        tl, tc = model.decode(params, {k: torch.tensor(v) for k, v in step.items()}, tc)
        close(tl, jl, atol)
        for a, b in zip(tc, jc):
            close(a, b, atol)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lengths = lengths + 1
    return tl, tc
