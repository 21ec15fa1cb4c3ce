"""The power of ``chip_smoke.py``'s attention check at the new families' sites.

On the card, ``chip_smoke.py`` holds each attention kernel against its plain
version twice: on the inputs its site was handed and on probe inputs of the
same shapes, mask and lengths (``attention_probe``), each within 2e-2
absolute and, in bfloat16, 1e-2 of each output row's norm
(``attention_errors``). At every site it also plants faults
(``planted_faults``: the last K/V tile or the last split dropped) and
requires the check to reject each on the probe inputs.

Here, on the CPU, at the shapes of llava's and whisper's sites (the batch
cut where the plain version would be slow), the kernels' algorithms
emulated step for step
(``tests/test_torch_attention_split.py``, held there against the reference)
pass the check on the probe inputs, and every planted fault fails it. On
inputs as flat as a model's random weights give at whisper's cross site, a
dropped ragged tile stays inside the check: the probe is what sees it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.kernels import ref
from test_torch_attention_split import flash_bf16_emulation, split_decode_emulation

BF16 = torch.bfloat16


def _flash_probe(B, Sq, Skv, H, KH, D):
    q = torch.zeros((B, Sq, H, D), dtype=BF16)
    k = torch.zeros((B, Skv, KH, D), dtype=BF16)
    return cs.attention_probe("flash_attention", (q, k, torch.zeros_like(k)))


def _decode_probe(B, S, H, KH, D, lengths):
    q = torch.zeros((B, H, D), dtype=BF16)
    kc = torch.zeros((B, S, KH, D), dtype=BF16)
    lengths = torch.as_tensor(np.broadcast_to(lengths, (B,)), dtype=torch.int32)
    return cs.attention_probe("decode_attention", (q, kc, torch.zeros_like(kc), lengths))


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal,faults", [
    (1, 1500, 1500, 12, 12, 64, False, 1),  # whisper's encoder: 28 ragged rows
    (16, 4, 1500, 12, 12, 64, False, 1),  # whisper's cross prefill, 4 tokens
    (4, 224, 1500, 12, 12, 64, False, 1),  # and 224
    (16, 224, 224, 12, 12, 64, True, 1),  # whisper's self prefill
    (16, 4, 4, 12, 12, 64, True, 0),  # one tile: dropping it leaves no key
    (1, 1088, 1088, 56, 8, 128, True, 1),  # llava's prefill at G = 7
], ids=["encoder", "cross-4", "cross-224", "self-224", "self-4", "llava-prefill"])
def test_flash_check_passes_the_kernels_algorithm_and_rejects_planted_faults(
        B, Sq, Skv, H, KH, D, causal, faults):
    args = _flash_probe(B, Sq, Skv, H, KH, D)
    kwargs = {"causal": causal, "scale": D ** -0.5}
    want = ref.flash_attention_ref(*args, **kwargs)
    err, rel, ok = cs.attention_errors(flash_bf16_emulation(*args, **kwargs), want)
    assert ok, (err, rel)
    planted = cs.planted_faults("flash_attention", kwargs, args)
    assert len(planted) == faults
    for what, bad in planted:
        assert not cs.attention_errors(bad, want)[2], what


@pytest.mark.parametrize("B,S,H,KH,D,lengths,faults", [
    (7, 1124, 56, 8, 128, 1089, 2),  # llava's decode at G = 7
    (16, 1500, 12, 12, 64, 1500, 2),  # whisper's cross decode: 2 splits, 28 ragged rows
    (16, 1500, 12, 12, 64, np.arange(16) * 93 + 65, 2),  # the cross cache at ragged lengths
    (16, 292, 12, 12, 64, 225, 2),  # whisper's self decode
    (16, 72, 12, 12, 64, 5, 0),  # one split, one tile: nothing to drop
], ids=["llava-decode", "cross-decode", "cross-ragged", "self-decode", "self-5"])
def test_decode_check_passes_the_kernels_algorithm_and_rejects_planted_faults(
        B, S, H, KH, D, lengths, faults):
    args = _decode_probe(B, S, H, KH, D, lengths)
    scale = D ** -0.5
    want = ref.decode_attention_ref(*args, scale=scale)
    err, rel, ok = cs.attention_errors(split_decode_emulation(*args, scale=scale), want)
    assert ok, (err, rel)
    planted = cs.planted_faults("decode_attention", {"scale": scale}, args)
    assert len(planted) == faults
    for what, bad in planted:
        assert not cs.attention_errors(bad, want)[2], what


def test_a_flat_cross_site_hides_a_dropped_tile_that_the_probe_shows():
    """whisper's cross attention under random weights of std 0.02: K/V
    rows of about 0.011 around a shared bias of 0.02, near-flat scores. A
    kernel that dropped the ragged 28 rows would pass on such inputs; on
    the probe inputs of the same shapes it fails."""
    rng = np.random.default_rng(0)
    B, Sq, Skv, H, D = 16, 4, 1500, 12, 64

    def t(a):
        return torch.tensor(a, dtype=torch.float32).to(BF16)

    q = t(rng.normal(0, 0.3, (B, Sq, H, D)))
    k = t(rng.normal(0, 0.011, (B, Skv, H, D)) + rng.normal(0, 0.02, (H, D)))
    v = t(rng.normal(0, 0.011, (B, Skv, H, D)) + rng.normal(0, 0.02, (H, D)))
    kwargs = {"causal": False, "scale": D ** -0.5}
    (what, bad), = cs.planted_faults("flash_attention", kwargs, (q, k, v))
    assert "28 of 1500" in what
    assert cs.attention_errors(bad, ref.flash_attention_ref(q, k, v, **kwargs))[2]
    probe = cs.attention_probe("flash_attention", (q, k, v))
    (_, bad), = cs.planted_faults("flash_attention", kwargs, probe)
    assert not cs.attention_errors(bad, ref.flash_attention_ref(*probe, **kwargs))[2]


def test_check_attention_raises_on_a_planted_fault_and_returns_both_errors():
    args = _decode_probe(4, 300, 8, 2, 64, 300)
    want = ref.decode_attention_ref(*args, scale=0.125)
    err, rel = cs.check_attention(want.clone(), want, "decode_attention")
    assert err == 0.0 and rel == 0.0
    (_, bad), = [f for f in cs.planted_faults("decode_attention", {"scale": 0.125}, args)
                 if "splits" in f[0]]
    with pytest.raises(RuntimeError, match="of a row's norm"):
        cs.check_attention(bad, want, "decode_attention")


def test_probe_keeps_shapes_dtypes_and_lengths_and_is_seeded():
    q = torch.zeros((2, 3, 4, 16), dtype=BF16)
    kc = torch.zeros((2, 40, 2, 16), dtype=BF16)
    lengths = torch.tensor([7, 40], dtype=torch.int32)
    a = cs.attention_probe("decode_attention", (q, kc, kc.clone(), lengths))
    b = cs.attention_probe("decode_attention", (q, kc, kc.clone(), lengths))
    assert [x.shape for x in a[:3]] == [q.shape, kc.shape, kc.shape]
    assert all(x.dtype == BF16 for x in a[:3]) and a[3] is lengths
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert 0.2 < float(a[2].float().std()) < 0.3 < 0.9 < float(a[1].float().std()) < 1.1
