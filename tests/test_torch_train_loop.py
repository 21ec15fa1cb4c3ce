"""The port's training driver (``repro_torch.launch.train.train_loop``) on
the CPU: resumed from the JAX package's checkpoint beside the reference's
own loop, its losses within 1e-5 (rtol) of the reference's over the same
loader batches; the port's copies of ``tests/test_train_serve.py``'s loop
tests; preemption; and the attention kernels' refusal of gradients, which
the loss path never reaches."""
from __future__ import annotations

import os
import shutil
import signal

import numpy as np
import pytest
import torch

from repro.launch.train import train_loop as jtrain_loop
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import reduced_config
from repro_torch.data.loader import TokenLoader
from repro_torch.distributed import StragglerMonitor
from repro_torch.kernels import ops
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model

QUIET = dict(log_every=100, print_fn=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes: two threads, not every core of a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compress", [False, True])
def test_port_resumes_the_reference_checkpoint_and_matches_its_losses(tmp_path, compress):
    """The reference trains five steps and checkpoints step 4; both loops
    resume from that checkpoint for four more steps over the same loader
    batches (the optimizer state and ``step`` ride in it)."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(arch="qwen2-0.5b", batch=4, seq=40, lr=2e-3, **QUIET)
    jtrain_loop(steps=5, ckpt_dir=ref_dir, ckpt_every=5, **kw)
    shutil.copytree(ref_dir, port_dir)
    want = jtrain_loop(steps=9, ckpt_dir=ref_dir, ckpt_every=100, resume=True,
                       compress=compress, **kw)
    got = train_loop(steps=9, ckpt_dir=port_dir, ckpt_every=100, resume=True,
                     compress=compress, device="cpu", **kw)
    assert got["final_step"] == want["final_step"] == 8
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert int(got["opt_state"]["step"]) == 9


def test_loop_off_the_card_steps_the_whole_batch_at_once(tmp_path):
    """granite-3-8b's config asks for 4 microbatches, which do not split a
    batch of 6. The reference's loop steps the whole batch at once, and so
    does the port's off the card: both resume the reference's step-0
    checkpoint for two steps on all 6 sequences, losses within rtol 1e-5."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(arch="granite-3-8b", batch=6, seq=24, lr=2e-3, **QUIET)
    jtrain_loop(steps=1, ckpt_dir=ref_dir, ckpt_every=1, **kw)
    shutil.copytree(ref_dir, port_dir)
    want = jtrain_loop(steps=3, ckpt_dir=ref_dir, ckpt_every=100, resume=True, **kw)
    got = train_loop(steps=3, ckpt_dir=port_dir, ckpt_every=100, resume=True, device="cpu",
                     **kw)
    assert reduced_config("granite-3-8b").accum_steps == 4 and got["accum_steps"] == 1
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


def test_loss_decreases_on_planted_bigrams():
    out = train_loop(arch="qwen2-0.5b", steps=30, batch=8, seq=64, lr=2e-3, ckpt_dir=None,
                     device="cpu", **QUIET)
    losses = out["losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    assert len(out["step_s"]) == len(out["load_s"]) == 30


def test_checkpoint_resume_continues(tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(arch="qwen2-0.5b", batch=4, seq=32, ckpt_dir=d, ckpt_every=5, device="cpu",
              **QUIET)
    a = train_loop(steps=10, **kw)
    b = train_loop(steps=14, resume=True, **kw)
    assert b["final_step"] == 13
    assert len(b["losses"]) == 14 - 10  # the resumed run trains only the remaining steps
    _, tree, _ = load_checkpoint(d, step=9)
    for k in ("embed", "final_norm"):
        np.testing.assert_array_equal(tree["params"][k], a["params"][k].numpy())


def test_dead_host_shards_reassigned_deterministically():
    mon = StragglerMonitor(n_hosts=4)
    loader = TokenLoader(global_batch=8, seq_len=16, vocab=64, n_shards=4, monitor=mon)
    full = loader.batch(3, [0, 1, 2, 3])
    mon.mark_dead(2)
    plan = mon.plan_shards(4)
    assert 2 not in plan
    assert sorted(s for ss in plan.values() for s in ss) == [0, 1, 2, 3]
    again = loader.batch(3, sorted(s for ss in plan.values() for s in ss))
    np.testing.assert_array_equal(full["tokens"], again["tokens"])


def test_killed_host_mid_run_keeps_the_batches():
    kw = dict(arch="qwen2-0.5b", steps=4, batch=8, seq=16, device="cpu", **QUIET)
    a = train_loop(**kw)
    b = train_loop(kill_host=1, kill_at_step=2, **kw)
    assert a["losses"] == b["losses"]


def test_sigterm_drains_a_blocking_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")

    def term(step, params, metrics):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    out = train_loop(arch="qwen2-0.5b", steps=10, batch=4, seq=16, ckpt_dir=d,
                     ckpt_every=100, device="cpu", on_step=term, **QUIET)
    assert out["final_step"] == 1 and len(out["losses"]) == 2
    assert sorted(os.listdir(d)) == ["step_00000001"]
    assert signal.getsignal(signal.SIGTERM) is not None


def test_attention_kernels_refuse_inputs_that_require_grad():
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_op(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention_op(q[:, 0], k, v, torch.tensor([8]))
    with torch.no_grad():  # serving a trained model: no graph, no refusal
        assert ops.flash_attention_op(q, k, v).shape == q.shape


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen2-moe-a2.7b", "llava-next-34b"])
def test_the_loss_never_reaches_the_kernels(monkeypatch, name):
    def refuse(*a, **k):
        raise AssertionError("the training loss reached an attention kernel")

    monkeypatch.setattr(ops, "flash_attention_op", refuse)
    monkeypatch.setattr(ops, "decode_attention_op", refuse)
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "flash_attention_op", refuse)
    monkeypatch.setattr(layers, "decode_attention_op", refuse)
    cfg = reduced_config(name)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 24)), dtype=torch.int32)}
    batch["labels"] = batch["tokens"]
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                                       generator=torch.Generator().manual_seed(1))
    from repro_torch.train.step import loss_and_grads

    loss, grads = loss_and_grads(model.loss, params, batch)
    assert torch.isfinite(loss)
    assert all(float(g.abs().max()) > 0 for g in _leaves(grads)
               if g.shape[0] != model.shapes["embed"][0])  # embed rows of unseen tokens: 0
    with pytest.raises(AssertionError, match="reached"):
        model.prefill(params, batch)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])
