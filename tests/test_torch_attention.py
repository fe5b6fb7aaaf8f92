"""Key extents, rounding points and the tensor-core attention kernels.

On the CPU, against the JAX package and against themselves:
* ``key_extent`` is one past each row's last real key, T for a row with
  none, on prefix masks, masks with holes and an all-masked row;
* the plain attention and its gradients over the 64-key tiles below the
  extent, the keys the CUDA kernels visit, are bit-equal to the same
  functions over every key, on rows with a real key (past the extent every
  bias is NEG and p is exactly 0);
* the plain versions round p (and ds) to the input dtype where the TPU
  kernel rounds them: for f32 that is the identity, bit for bit; for bf16
  they match the interpret-mode Pallas kernel and its VJP within 8e-3, one
  bf16 ulp of values below 2 (measured here: 2.0e-3 at worst; up to 7.8e-3
  before the plain versions rounded where the kernel does);
* the check that holds K3 to its plain version on the card
  (``chip_smoke.grad_rel_errs``) fails a gradient that is wrong on one real
  row, which a maximum over the all-masked rows as well would let pass;
* the trunk builds its key padding once per forward, remat included.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda_attention.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacy_ray_tpu.ops.flash_attention as fa

from chip_smoke import TOL_K3_BF16, grad_rel_errs

import spacy_ray_tpu_torch as P
import spacy_ray_tpu_torch.models.transformer as TR
import spacy_ray_tpu_torch.ops.flash_attention as tfa
from spacy_ray_tpu_torch.ops.flash_attention import (
    FlashAttention, key_padding, mask_to_bias,
)

BF16_ULP_BELOW_2 = 8e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa, "_INTERPRET", True)


def _mask(B, T, kind, seed):
    """[B, T] bool: prefix lengths, or random holes; the first row ends in
    padding, the last row has no real key."""
    rng = np.random.default_rng(seed)
    if kind == "prefix":
        lens = np.array([T - 9 - (T // (B + 1)) * i for i in range(B - 1)] + [0])
        mask = np.arange(T)[None, :] < lens[:, None]
    else:
        mask = rng.random((B, T)) < 0.6
        mask[0, T // 3:] = False
        mask[-1] = False
    return mask


def _inputs(B, T, H, Dh, kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, Dh)).astype(np.float32) for _ in range(4))
    dlse = rng.standard_normal((B, T, H)).astype(np.float32)
    return q, k, v, do, dlse, _mask(B, T, kind, seed)


# ------------------------------------------------------------ key extent


@pytest.mark.parametrize("kind", ["prefix", "holes"])
def test_key_extent_is_one_past_the_last_real_key(kind):
    B, T = 6, 37
    mask = _mask(B, T, kind, seed=1)
    mask[1] = True  # a row whose last key is real
    keys = key_padding(_t(mask))
    assert keys.extent.dtype == torch.int32 and keys.extent.shape == (B,)
    for b in range(B):
        real = np.flatnonzero(mask[b])
        assert int(keys.extent[b]) == (real[-1] + 1 if real.size else T), b
    assert int(keys.extent[-1]) == T  # the all-masked row attends to every key
    assert torch.equal(keys.bias, mask_to_bias(_t(mask)))
    past = torch.arange(T)[None, :] >= keys.extent[:, None].long()
    assert bool((keys.bias[past] == tfa.NEG).all())


def _run(q, k, v, do, dlse, bias, extent, dtype):
    tq, tk, tv = (_t(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    o, lse = FlashAttention.apply(tq, tk, tv, bias, q.shape[-1] ** -0.5, extent)
    grads = torch.autograd.grad((o, lse), (tq, tk, tv), (_t(do).to(dtype), _t(dlse)))
    return [o.detach(), lse.detach(), *grads]


KEY_TILE = 64  # keys per tile in both CUDA kernels: they visit the tiles below the extent


def _tiles_below(extent: int, T: int) -> int:
    return min(T, -(-extent // KEY_TILE) * KEY_TILE)


def _cut_run(q, k, v, do, dlse, bias, n, dtype):
    """:func:`_run` over the first ``n`` keys only; dk and dv padded back to T."""
    got = _run(q, k[:, :n], v[:, :n], do, dlse, bias[:, :n], None, dtype)
    pad = lambda g: torch.cat([g, g.new_zeros((g.shape[0], q.shape[1] - n) + g.shape[2:])], 1)  # noqa: E731
    return got[:3] + [pad(got[3]), pad(got[4])]


@pytest.mark.parametrize("kind", ["prefix", "holes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_over_the_key_extent_is_bit_equal(kind, dtype):
    B, T, H, Dh = 4, 150, 2, 16
    q, k, v, do, dlse, mask = _inputs(B, T, H, Dh, kind, seed=5)
    keys = key_padding(_t(mask))
    skipped = 0
    for b in range(B):  # each row alone, over the key tiles the kernels visit for it
        row = slice(b, b + 1)
        args = (q[row], k[row], v[row], do[row], dlse[row], keys.bias[row])
        e = int(keys.extent[b])
        full = _run(*args, None, dtype)
        cut = _cut_run(*args, _tiles_below(e, T), dtype)
        skipped += -(-T // KEY_TILE) - -(-_tiles_below(e, T) // KEY_TILE)
        for name, a, c in zip(("o", "lse", "dq", "dk", "dv"), full, cut):
            assert torch.equal(a, c), (b, name)
        assert not full[3][:, e:].any() and not full[4][:, e:].any()  # dk, dv past the extent
        if not mask[b].any():
            assert e == T and torch.isfinite(full[0]).all()
    assert skipped >= 2  # tiles: the first row and the prefix rows end early
    # the whole batch at once, every row cut short: the tiles below the
    # largest extent of a real row
    mask &= np.arange(T)[None, :] < 100
    keys = key_padding(_t(mask))
    real = mask.any(axis=1)
    n = _tiles_below(int(keys.extent[_t(real)].max()), T)
    assert n < T
    whole = _run(q, k, v, do, dlse, keys.bias, None, dtype)
    cut = _cut_run(q, k, v, do, dlse, keys.bias, n, dtype)
    for a, c in zip(whole, cut):
        assert torch.equal(a[real], c[real])


@pytest.mark.parametrize("B,T,H,Dh", [(3, 70, 2, 16), (2, 200, 3, 64)])
def test_f32_plain_rounding_is_the_identity(monkeypatch, B, T, H, Dh):
    q, k, v, do, dlse, mask = _inputs(B, T, H, Dh, "prefix", seed=T)
    keys = key_padding(_t(mask))
    rounded = _run(q, k, v, do, dlse, keys.bias, keys.extent, torch.float32)
    monkeypatch.setattr(tfa, "_rounded", lambda x, dtype: x)  # the unrounded formula
    unrounded = _run(q, k, v, do, dlse, keys.bias, keys.extent, torch.float32)
    for a, b in zip(rounded, unrounded):
        assert torch.equal(a, b)


def _kernel_vjp(q, k, v, do, dlse, mask):
    """The interpret-mode Pallas kernel's (o, VJP) in bf16, trunk layout."""
    B, T, H, Dh = q.shape
    lay = lambda x: fa._to_kernel_layout(jnp.asarray(x, jnp.bfloat16))  # noqa: E731
    fl = fa._make_flash_lse(1.0 / Dh ** 0.5)
    (o, lse), vjp = jax.vjp(fl, lay(q), lay(k), lay(v), fa._mask_to_bias(jnp.asarray(mask)))
    dlse_k = jnp.pad(jnp.asarray(dlse).transpose(0, 2, 1), ((0, 0), (0, 0), (0, lse.shape[2] - T)))
    outs = (o,) + vjp((lay(do), dlse_k))[:3]
    return [np.asarray(x[:, :, :T, :Dh].astype(jnp.float32)).transpose(0, 2, 1, 3) for x in outs]


@pytest.mark.parametrize("B,T,H,Dh,kind", [(2, 130, 2, 32, "prefix"), (3, 70, 2, 16, "holes"),
                                           (2, 200, 3, 64, "prefix")])
def test_bf16_plain_matches_interpreted_kernel_where_it_rounds(interpret, B, T, H, Dh, kind):
    q, k, v, do, dlse, mask = _inputs(B, T, H, Dh, kind, seed=Dh)
    keys = key_padding(_t(mask))
    got = _run(q, k, v, do, dlse, keys.bias, keys.extent, torch.bfloat16)
    got = [x.float().numpy() for i, x in enumerate(got) if i != 1]  # o, dq, dk, dv
    want = _kernel_vjp(q, k, v, do, dlse, mask)
    real = mask.any(axis=1)  # the all-masked row differs by construction (Queue C 1)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g[real], w[real], atol=BF16_ULP_BELOW_2, rtol=0, err_msg=name)


def test_k3_check_fails_a_gradient_wrong_on_one_real_row():
    B, T, H, Dh = 3, 70, 12, 64  # chip_smoke.py's K3 check shape, rows of 70, 33 and 0 keys
    rng = np.random.default_rng(11)
    q, k, v, do = (_t(rng.standard_normal((B, T, H, Dh)).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    mask = torch.arange(T)[None, :] < torch.tensor([T, 33, 0])[:, None]
    keys = key_padding(mask)
    o, lse = tfa.flash_attention_plain(q, k, v, keys.bias, Dh ** -0.5)
    want = tfa.flash_attention_bwd_plain(q, k, v, keys.bias, o, lse, do, None, Dh ** -0.5)
    real = mask.any(dim=1)
    assert grad_rel_errs(want, want, real) == {"real": [0.0] * 3, "masked": [0.0] * 3}
    bad = [want[0].clone(), *want[1:]]
    bad[0][1, 5] = 0  # dq of one query of the 33-key row
    rel = grad_rel_errs(bad, want, real)
    assert rel["real"][0] > TOL_K3_BF16 and max(rel["masked"]) == 0.0
    # the all-masked row's dq is an order larger: against its maximum the
    # same fault is inside the tolerance
    whole = (bad[0].float() - want[0].float()).abs().max() / want[0].float().abs().max()
    assert whole <= TOL_K3_BF16


# ------------------------------------------------------------- the trunk


TRUNK_CFG = """
[nlp]
lang = "en"
pipeline = ["transformer", "tagger"]

[components]

[components.transformer]
factory = "transformer"

[components.transformer.model]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 32
depth = 3
n_heads = 2
ffn_mult = 2
dropout = 0.1
max_len = 64
embed_size = 200
remat = true

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = ${components.transformer.model.width}
"""


def test_trunk_builds_its_key_padding_once_per_forward(monkeypatch):
    nlp = P.Pipeline.from_config(P.Config.from_str(TRUNK_CFG).interpolate(), device="cpu")
    nlp.initialize(labels={"tagger": ["A", "B", "C"]}, seed=0)
    docs = [P.Doc(words=w.split(), tags=["A"] * len(w.split()))
            for w in ("the cat sat", "a dog", "one two three four five")]
    batch = nlp.collate([P.Example.from_gold(d) for d in docs], with_targets=True)
    calls = {"key_padding": 0, "mask_to_bias": 0, "attention": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(TR, "key_padding", counted("key_padding", TR.key_padding))
    monkeypatch.setattr(tfa, "mask_to_bias", counted("mask_to_bias", tfa.mask_to_bias))
    monkeypatch.setattr(TR, "masked_attention", counted("attention", TR.masked_attention))
    nlp.forward(batch["tokens"])
    assert calls == {"key_padding": 1, "mask_to_bias": 1, "attention": 3}
    nlp.model.requires_grad_(True)
    loss, _ = nlp.loss(batch["tokens"], batch["targets"], dropout=0.1, seed=4)
    loss.backward()  # remat recomputes each layer with the same key padding
    assert calls == {"key_padding": 2, "mask_to_bias": 2, "attention": 9}
