"""The tensor-core attention kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc, carries the ``cuda`` marker
and skips without a card. The file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_attention.py

Inputs are q/k/v as strided views of a fused qkv projection, with masks of
prefix lengths or holes, a row that ends in padding and an all-masked row,
and the key extent the trunk passes. Tolerances are those of
``chip_smoke.py``: the forward (K2) within 1e-2 on o in bf16 (about an ulp
at |o| ~ 2), 1e-4 in f32, 1e-3 on the f32 lse; the backward (K3) within
5e-2 of max |grad| in bf16, over the rows with a real key and over the
all-masked rows apart (``chip_smoke.grad_rel_errs``), and 1e-3 in f32; two
runs of K3 bit-identical.
"""

import numpy as np
import pytest
import torch

from chip_smoke import TOL_K3_BF16, grad_rel_errs, train_lengths
from spacy_ray_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain, key_padding,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda"), torch.Generator(device="cuda").manual_seed(0)


def _mask(B, T, kind, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "prefix":
        lens = np.array([T - 9 - (T // (B + 1)) * i for i in range(B - 1)] + [0])
        mask = np.arange(T)[None, :] < lens[:, None]
    else:
        mask = rng.random((B, T)) < 0.6
        mask[0, T // 3:] = False
        mask[-1] = False
    return torch.from_numpy(mask).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [70, 130, 512])
def test_cuda_attention_kernels_match_plain_versions(T):
    dev, g = _card()
    for dt, H, Dh, kind in ((torch.bfloat16, 12, 64, "prefix"), (torch.bfloat16, 4, 16, "holes"),
                            (torch.float32, 4, 64, "holes")):
        B, D = 4, H * Dh
        scale = Dh ** -0.5
        qkv = torch.randn(B, T, 3 * D, device=dev, generator=g).to(dt)
        q, k, v = (x.view(B, T, H, Dh) for x in qkv.split(D, dim=-1))
        keys = key_padding(_mask(B, T, kind, T, dev))
        o, lse = flash_attention_fwd(q, k, v, keys.bias, scale, keys.extent)
        o2, lse2 = flash_attention_plain(q, k, v, keys.bias, scale)
        assert torch.isfinite(o.float()).all()
        tol_o = 1e-2 if dt == torch.bfloat16 else 1e-4
        torch.testing.assert_close(o.float(), o2.float(), atol=tol_o, rtol=0)
        torch.testing.assert_close(lse, lse2, atol=1e-3, rtol=0)
        do = torch.randn(B, T, H, Dh, device=dev, generator=g).to(dt)
        for dlse in (torch.randn(B, T, H, device=dev, generator=g), None):
            args = (q, k, v, keys.bias, o, lse, do, dlse, scale)
            got = flash_attention_bwd(*args, keys.extent)
            want = flash_attention_bwd_plain(*args)
            assert all(torch.isfinite(a.float()).all() for a in got)
            if dt == torch.bfloat16:
                rel = grad_rel_errs(got, want, keys.bias.amax(dim=1) == 0)
                assert max(rel["real"] + rel["masked"]) <= TOL_K3_BF16, (Dh, rel)
            else:
                errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
                assert max(errs) <= 1e-3, (Dh, errs)
            again = flash_attention_bwd(*args, keys.extent)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_attention_takes_rows_that_are_not_16_byte_aligned():
    # a time stride of 3 * 64 + 4 elements puts bf16 rows off the 16 bytes
    # cp.async needs: the wrappers copy such inputs before they launch
    dev, g = _card()
    B, T, H, Dh = 2, 70, 4, 16
    wide = torch.randn(B, T, 3 * H * Dh + 4, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, Dh) for x in wide[..., :3 * H * Dh].split(H * Dh, dim=-1))
    assert q.stride(1) % 8 != 0
    keys = key_padding(_mask(B, T, "prefix", 1, dev))
    o, lse = flash_attention_fwd(q, k, v, keys.bias, Dh ** -0.5, keys.extent)
    o2, lse2 = flash_attention_plain(q, k, v, keys.bias, Dh ** -0.5)
    torch.testing.assert_close(o.float(), o2.float(), atol=1e-2, rtol=0)
    do = torch.randn(B, T, H, Dh, device=dev, generator=g).to(torch.bfloat16)
    got = flash_attention_bwd(q, k, v, keys.bias, o, lse, do, None, Dh ** -0.5, keys.extent)
    want = flash_attention_bwd_plain(q, k, v, keys.bias, o, lse, do, None, Dh ** -0.5)
    rel = grad_rel_errs(got, want, keys.bias.amax(dim=1) == 0)
    assert max(rel["real"] + rel["masked"]) <= TOL_K3_BF16, rel


@pytest.mark.cuda
def test_cuda_flash_attention_autograd_matches_plain_backward():
    dev, g = _card()
    B, T, H, Dh = 3, 130, 4, 64
    q, k, v = (torch.randn(B, T, H, Dh, device=dev, generator=g).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    mask = _mask(B, T, "prefix", 2, dev)
    do = torch.randn(B, T, H, Dh, device=dev, generator=g).to(torch.bfloat16)
    dlse = torch.randn(B, T, H, device=dev, generator=g)
    o, lse = flash_attention(q, k, v, mask)
    got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    keys = key_padding(mask)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), keys.bias,
                                     o.detach(), lse.detach(), do, dlse, Dh ** -0.5)
    rel = grad_rel_errs(got, want, mask.any(dim=1))
    assert max(rel["real"] + rel["masked"]) <= TOL_K3_BF16, rel


@pytest.mark.cuda
def test_cuda_k3_check_catches_a_wrong_real_row():
    # at the training shape the all-masked batch-padding rows hold the
    # largest gradients; a dq that is zero on one real query row must still
    # fail the check that chip_smoke.py holds K3 to
    dev, g = _card()
    B, T, H, Dh = 64, 128, 12, 64
    qkv = torch.randn(B, T, 3 * H * Dh, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, Dh) for x in qkv.split(H * Dh, dim=-1))
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(train_lengths(), device=dev)[:, None]
    keys = key_padding(mask)
    o, lse = flash_attention_fwd(q, k, v, keys.bias, Dh ** -0.5, keys.extent)
    do = torch.randn(B, T, H, Dh, device=dev, generator=g).to(torch.bfloat16)
    args = (q, k, v, keys.bias, o, lse, do, None, Dh ** -0.5)
    got = list(flash_attention_bwd(*args, keys.extent))
    want = flash_attention_bwd_plain(*args)
    real = mask.any(dim=1)
    assert not bool(real.all())
    assert max(grad_rel_errs(got, want, real)["real"]) <= TOL_K3_BF16
    got[0] = got[0].clone()
    got[0][int(real.nonzero()[0]), 5] = 0
    assert max(grad_rel_errs(got, want, real)["real"]) > TOL_K3_BF16
