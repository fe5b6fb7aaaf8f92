"""The fused update's (K5) chunk plan and table, on the CPU.

The K5 kernel walks a table of chunks built on the host once per parameter
set (``ops/fused_update.py``: ``chunk_plan``, ``chunk_rows``). These tests
hold the plan to what the kernel assumes: every element of every leaf in
exactly one chunk of at most ``chunk`` elements; vector chunks 16-byte
aligned in all four of p, g, m, v and a multiple of 4 long; a leaf whose
four tensors sit at different offsets from 16 bytes in scalar chunks only.
The table's addresses are then used to run the plain per-element chain
chunk by chunk on one flat buffer, which must give the per-leaf result bit
for bit. The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from spacy_ray_tpu_torch.ops.fused_update import (
    CHUNK, VEC, FusedHyper, chunk_plan, chunk_rows, leaf_math_plain, step_scalars,
)

SIZES = (0, 1, 3, 4, 5, 7, 65535, 65537, 262147)


def _leaves(seed):
    """(numel, p, g, m, v) with byte addresses at float offsets 0-3 from a
    16-byte boundary: all four alike (head and tail scalar, body vector) or
    each its own (scalar only)."""
    rng = np.random.default_rng(seed)
    leaves = []
    for n in SIZES:
        base = [int(b) * 4096 for b in rng.integers(1, 1 << 30, 4)]
        same = int(rng.integers(0, 4))
        leaves.append((n, *(b + 4 * same for b in base)))
        mixed = rng.permutation(4)
        leaves.append((n, *(b + 4 * int(o) for b, o in zip(base, mixed))))
    return leaves


@pytest.mark.parametrize("chunk", [VEC, 8, 1 << 16, CHUNK])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_plan_covers_each_element_once_and_aligns_vectors(chunk, seed):
    leaves = _leaves(seed)
    plan = chunk_plan(leaves, chunk)
    covered = [np.zeros(n, np.int64) for n, *_ in leaves]
    for c in plan:
        assert 0 <= c.start < c.stop <= leaves[c.leaf][0]
        assert c.stop - c.start <= chunk
        covered[c.leaf][c.start:c.stop] += 1
        if c.vec:
            assert (c.stop - c.start) % VEC == 0
            assert all((a + 4 * c.start) % 16 == 0 for a in leaves[c.leaf][1:])
    assert all((cov == 1).all() for cov in covered)
    assert [c.leaf for c in plan] == sorted(c.leaf for c in plan)
    for i, (n, *addrs) in enumerate(leaves):
        scalar = sum(c.stop - c.start for c in plan if c.leaf == i and not c.vec)
        if len({a % 16 for a in addrs}) > 1:
            assert scalar == n  # mixed alignment: scalar chunks only
        else:
            assert scalar <= min(n, 2 * (VEC - 1))  # a head and a tail of at most 3


def test_chunk_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="multiple"):
        chunk_plan([(8, 0, 0, 0, 0)], 6)
    with pytest.raises(ValueError, match="multiple"):
        chunk_plan([(8, 0, 0, 0, 0)], 0)
    with pytest.raises(ValueError, match="4-byte"):
        chunk_plan([(8, 0, 2, 0, 0)], 8)


@pytest.mark.parametrize("hyper", [
    FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.01),
    FusedHyper("radam", 0.9, 0.99, 1e-6, 0.5, 0.01, 0.0),
], ids=["adam", "radam"])
def test_chunk_rows_address_the_leaves_they_update(hyper):
    # p, g, m, v of each leaf at its own float offset in one flat buffer; the
    # chain run chunk by chunk through the table's addresses equals the chain
    # run leaf by leaf
    rng = np.random.default_rng(3)
    sizes = (1, 3, 5, 70, 4099, 9)
    mem = rng.standard_normal(4 * sum(sizes) + 64).astype(np.float32)
    mem[:] = np.abs(mem) * 0.01  # v must be non-negative; all slots alike
    offset = 1
    leaves, slots = [], []
    for j, n in enumerate(sizes):
        at = []
        for k in range(4):
            at.append(offset)
            offset += n + (j + k) % 3
        slots.append(at)
        leaves.append((n, *(4 * a for a in at)))
    assert offset <= mem.size
    flat = torch.from_numpy(mem.copy())
    gnorm = torch.tensor(0.7, dtype=torch.float32)
    sc = step_scalars(hyper, 6, 6, lambda s: 0.001)
    want = [leaf_math_plain(*(flat[a:a + n] for a in at), gnorm, *sc, hyper=hyper)
            for (n, *_), at in zip(leaves, slots)]
    got = flat.clone()
    for p, g, m, v, n, vec in chunk_rows(leaves, 8):
        P, G, M, V = (got[a // 4:a // 4 + n] for a in (p, g, m, v))
        p2, m2, v2 = leaf_math_plain(P, G, M, V, gnorm, *sc, hyper=hyper)
        P.copy_(p2)
        M.copy_(m2)
        V.copy_(v2)
    for (n, *_), at, (p2, m2, v2) in zip(leaves, slots, want):
        for a, w in zip((at[0], at[2], at[3]), (p2, m2, v2)):
            assert torch.equal(got[a:a + n], w)
        assert torch.equal(got[at[1]:at[1] + n], flat[at[1]:at[1] + n])  # g untouched


def test_chunk_rows_at_the_moe_leaf_sets_size_stay_within_the_kernels_types():
    # trf.cfg with 8 experts: 177 leaves, 531 M elements. Each expert leaf is
    # [8, 768, 3072] (18.9 M elements); the four buffers of the step sit
    # gigabytes apart, above 2**32 bytes. Every row's length must fit the
    # kernel's int, its addresses its 64-bit words, and the chunk count the
    # grid's x dimension.
    expert = 8 * 768 * 3072
    sizes = ([expert] * 24 + [768 * 2304, 768 * 768] * 12 + [20000 * 768]
             + [10000 * 768] * 3 + [768] * 125)
    total = sum(sizes)
    assert len(sizes) == 177 and total > 500_000_000
    base = [(1 << 33) + k * (4 * total + 4096) for k in range(4)]
    leaves, offset = [], 0
    for n in sizes:
        leaves.append((n, *(b + 4 * offset for b in base)))
        offset += n + (-n % 4)
    rows = chunk_rows(leaves)
    lengths = np.array([r[4] for r in rows], dtype=np.int64)
    assert lengths.sum() == total and lengths.max() <= CHUNK < 2 ** 31
    assert len(rows) < 2 ** 31 - 1
    last = rows[-1]
    assert last[0] + 4 * last[4] == leaves[-1][1] + 4 * leaves[-1][0]
    assert max(max(r[:4]) for r in rows) < 2 ** 63 and min(r[0] for r in rows) >= 1 << 33
