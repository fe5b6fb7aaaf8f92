#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

1. card     — ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build    — compiles every kernel of ``spacy_ray_tpu_torch/csrc`` with
              nvcc for sm_90a (one nvcc per source, in parallel), with each
              kernel's registers and spills (``ptxas -v``).
3. kernel:* — each kernel's wrapper on the card at the shapes its path
              gives it (the serving slice's for K1, K2, K4, and K1 also for
              one one-text request and a training microbatch; a training
              microbatch's and the whole parameter set's for the hash-embed
              gradient, the attention backward K3 and the fused update K5),
              held against its plain PyTorch version on the same inputs
              (tolerances below), and timed with CUDA events beside its
              plain version, a PyTorch library call computing the same
              function where one exists, and its bound; ``host_us`` is the
              host's time to launch it through its wrapper. K4 runs with
              bf16 x (the serving path's input; bytes bound at 2 bytes per
              element) and with f32 x; its library call is cuBLAS f32 on
              the dequantized weight, with cuBLAS bf16 beside it; the table
              gradient reports its device operations per call by name and
              time (``torch.profiler``) and is rerun bit-identical.
4. slice:*  — the transformer + tagger pipeline at the width of
              ``configs/trf.cfg`` (768 wide, 12 layers, 12 heads, FFN 3072,
              embed 20000; random weights from a seed), saved with
              ``to_disk`` and served through the ``serve`` entry point on
              port 0 (``--max-batch 8 --max-doc-len 128``), once with
              ``--precision auto`` (bf16) and once with ``--precision int8``.
              Launch counters are zeroed just before the requests and read
              just after; the trunk output of one batch is held against the
              same pipeline with every kernel swapped for its plain version,
              and one forward at the top bucket (B=8, T=128) is timed both
              ways.
5. cli      — ``python -m spacy_ray_tpu_torch serve`` as a subprocess
              answers one request.
6. train:trf — ``train()`` of the port on the card, on a config whose
              transformer and tagger blocks and ``[training]`` block are
              ``configs/trf.cfg``'s (``max_steps`` 40, ``eval_frequency``
              20), over a synthetic corpus written here (2000 train and 200
              dev docs of 8-120 words whose tags follow from the words).
              Launch counters are zeroed just before and read just after;
              every training kernel must have launched and the loss must
              fall. Then one step is split into forward, backward and
              optimizer (device and host-enqueue time), the gradients of one
              microbatch with every kernel are held against the same
              microbatch with every kernel swapped for its plain version
              (dropout off), and ``best-model/`` answers one request through
              the serving path.
7. train:full — ``train()`` on ``configs/trf.cfg`` as written (tagger,
              parser and NER heads, its score weights), ``max_steps`` 40 and
              ``eval_frequency`` 20, on a pseudo-UD corpus written here
              (``udgen``: 2000 train and 200 dev docs, seeds 0 and 1). The
              five training kernels must launch and each head's loss must
              fall to at most 2/3 of its start (means of the first and last
              5 steps); one microbatch's forward + backward is timed with
              every head and with the tagger alone (events, host clock,
              and kernel time and device operations under the
              profiler), and its gradients of
              every leaf, the heads' included, are held against the plain
              versions (dropout off).
8. slice:full — ``train:full``'s ``last-model/`` served at ``--precision
              auto`` with slice:auto's traffic over the dev texts: every doc
              answered with tags, heads and deps, the heads' decodes
              replayed as CUDA graphs. For one B 8, T 128 batch: the graph
              replay bit-equal to the eager decode of the same trunk output,
              the card's decode against a CPU decode (>= 0.99 agreement),
              the kernels against their plain versions (heads >= 0.95,
              entity sets F >= 0.95), and the decodes' device and enqueue
              times and device operations, as replays and eagerly.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before the last line. Without a card, or without the package beside this
file, it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import random
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
STREAM_COPIES = 16              # K1 fwd back to back: 16 copies of each table, past L2

# tolerances of kernel vs plain version on the same inputs
TOL_K1 = 0.0        # the same four f32 adds in the same order: bit-equal
TOL_K2_O = 1e-2     # bf16 output: about 1 ulp at |o| ~ 2 (2**-7 = 7.8e-3)
TOL_K2_LSE = 1e-3   # f32 log-sum-exp, different summation order
TOL_K4_REL = 1e-4   # f32 accumulation order, relative to max |out|
TOL_TRUNK = 0.1     # bf16 trunk after 12 layers, max |diff| on real tokens
TOL_K1_BWD = 0.0    # the same f32 adds in the same order as the CPU plain version
TOL_K3_F32 = 1e-3   # f32 dq/dk/dv, other summation order (tests/test_flash_attention.py)
TOL_K3_BF16 = 5e-2  # bf16 dq/dk/dv, relative to max |grad| (the JAX kernel probe's bound),
#                     over the rows with a real key and over all-masked rows apart
MAXULP_K5 = 1       # p, m, v against leaf_math_plain (bit-equal when no FMA is formed)
TOL_GRAD = 5e-2     # bf16 trunk gradients, kernels vs plain, relative to each leaf's max
TRAIN_STEPS, TRAIN_EVAL = 40, 20
TRAIN_B, TRAIN_T = 64, 128  # one training microbatch (batch_by_words 2000 on this corpus)

UD_TAGS = ["ADJ", "ADP", "ADV", "AUX", "CCONJ", "DET", "INTJ", "NOUN", "NUM",
           "PART", "PRON", "PROPN", "PUNCT", "SCONJ", "SYM", "VERB", "X"]
WORDS = ("the of and to in is was he for it with as his on be at by had are but "
         "from or have an they which one you were her all she there would their we "
         "him been has when who will more no if out so said what up its about into "
         "than them can only other new some could time these two may then do first "
         "any my now such like our over man me even most made after also did many "
         "before must through back years where much your way well down should because "
         "each just those people Mr how too little state good very make world still "
         "own see men work long get here between both life being under never day "
         "same another know while last might us great old year off come since against "
         "go came right used take three Paris London 1984 3.5 U.S. don't it's "
         "well-known e-mail").split()
PUNCT = [",", ".", ";", "!", "?", "(", ")"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def grad_rel_errs(got, want, real) -> dict:
    """For each of dq, dk, dv: max |got - want| relative to max |want| over
    the same batch rows, taken apart for the rows with a real key (``real``,
    [B] bool) and the all-masked rows. An all-masked row recomputes p = 1 on
    every key, so its dq and dv are sums over all T keys or queries, an order
    larger than a real row's: one maximum over both would let a wrong real
    row pass."""
    errs = {"real": [], "masked": []}
    for x, y in zip(got, want):
        for name, rows in (("real", real), ("masked", ~real)):
            if bool(rows.any()):
                a, b = x[rows].float(), y[rows].float()
                errs[name].append((a - b).abs().max().item()
                                  / max(b.abs().max().item(), 1e-30))
    return errs


# ----------------------------------------------------------- measurement


def time_ms(torch, fn, *, reps: int = 25, warmup: int = 3, flush=None,
            spin_cap_s: float = 0.05) -> float:
    """Median device milliseconds of one call, each timed with CUDA events
    around the call alone. Before each call the card spins
    (``torch.cuda._sleep``) for about twice the host's time to enqueue it,
    at most ``spin_cap_s``, so its kernels run back to back and the host's
    launch cost is not counted. With ``flush``, L2 is overwritten before
    each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(min(2 * host_s + 20e-6, spin_cap_s) * 2e9)  # cycles, at up to 2 GHz
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def back_to_back_ms(torch, fns, *, reps: int = 10, flush=None) -> float:
    """Median device milliseconds per call of the calls ``fns`` run back to
    back between one pair of CUDA events, after the card spins for twice the
    host's time to enqueue them all (so they queue up and the host's launch
    cost is not counted). With ``flush``, L2 is overwritten before each
    timed run."""
    def run():
        for fn in fns:
            fn()

    return time_ms(torch, run, reps=reps, warmup=1, flush=flush) / len(fns)


def enqueue_ms(torch, fn, *, reps: int = 10) -> float:
    """Median host milliseconds to enqueue one call, starting from an idle
    card. Close to the device time of the call when the host, not the
    card, sets the pace."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_us(torch, fn, *, reps: int = 100) -> float:
    """Mean host microseconds per call of back-to-back calls (the card runs
    behind; the launch queue is far from full at this count)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def train_lengths():
    """Lengths of a training microbatch's rows: about 36 docs of 8-120
    words, the rest batch-padding rows."""
    rng = random.Random(3)
    return [rng.randint(8, 120) for _ in range(36)] + [0] * (TRAIN_B - 36)


def corpus_keys(torch, g=None):
    """The hash keys [B*T, 2] of one training microbatch (B 64, T 128), as
    skewed as the training corpus makes them: a 45-word vocabulary, and
    every batch-padding position the zero key. Drawn first from ``g`` (a new
    generator of seed 1 when none is given, so that every caller gets the
    keys ``phase_train_kernels`` draws)."""
    dev = torch.device("cuda")
    if g is None:
        g = torch.Generator(device=dev).manual_seed(1)
    vocab = torch.randint(1, 2 ** 32, (45, 2), device=dev, generator=g)
    real = (torch.arange(TRAIN_T, device=dev)[None, :]
            < torch.tensor(train_lengths(), device=dev)[:, None]).reshape(-1)
    word = torch.randint(0, 45, (TRAIN_B * TRAIN_T,), device=dev, generator=g)
    return torch.where(real[:, None], vocab[word], torch.zeros_like(vocab[word]))


def ptxas_summary(log: str):
    """Registers, shared memory and spills of each kernel in an
    ``nvcc -Xptxas -v`` log."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            out.append({"kernel": name, "spill_stores": spills[0], "spill_loads": spills[1]})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            smem = re.search(r"(\d+) bytes smem", line)  # absent: dynamic shared memory
            out[-1].update({"registers": int(m.group(1)),
                            "smem_static": int(smem.group(1)) if smem else 0})
    for row in out:  # mangled names: keep the kernel and its head dim or x type
        name = row["kernel"]
        if "gather_sum" in name:
            row["kernel"] = "gather_sum"
            continue
        if "fused_update" in name:  # keep the template arguments
            args = re.findall(r"L[bi](\d+)E", name.split("fused_update", 1)[1].split("EEv")[0])
            row["kernel"] = f"fused_update<{','.join(args)}>"
            continue
        k = re.search(r"\d((?:flash_(?:fwd|bwd)|int8|table_grad|reduce)_\w+?)[IE]", name)
        dh = re.search(r"ILi(\d+)E", name)
        xt = "<bf16>" if "I13__nv_bfloat16E" in name else "<f32>" if "IfE" in name else ""
        row["kernel"] = (k.group(1) if k else name[:40]) + (f"<{dh.group(1)}>" if dh else xt)
    return out


def device_ops(torch, fn) -> dict:
    """The device operations (kernels, copies, fills) that one call of
    ``fn`` puts on the card, by name: ``{name: [count, device ms]}``, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            count, ms = out.get(e.key[:60], (0, 0.0))  # names cut to 60 may collide
            out[e.key[:60]] = [count + e.count, ms + us / 1e3]
    return out


# ---------------------------------------------------------------- phases


def phase_kernels(torch):
    """Each kernel against its plain version and timed, at slice shapes."""
    import torch.nn.functional as F

    from spacy_ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain, key_padding,
    )
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.ops.int8_matmul import (
        int8_matmul_plain, int8_weight_matmul, quantize_int8, split_k,
    )
    from spacy_ray_tpu_torch.ops.pallas_kernels import (
        hash_embed_gather_sum, hash_embed_gather_sum_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        scratch.zero_()

    results = {}
    B, T, D, H, Dh = 8, 128, 768, 12, 64

    # K1: the four hash tables of one serving dispatch (NORM 20000, three of
    # 10000), then the NORM table for one one-text request (B 1, T 128) and
    # for a training microbatch (B 64, T 128) on the corpus's skewed ids.
    # The bound counts each distinct table row a call names once (repeated
    # ids can never lift the share past 100 %), the output and the ids;
    # bound_ms_all_rows counts four rows a token, as the earlier count did.
    # A call of a few microseconds sits on the timer's floor (an empty kernel
    # timed alike, timer_floor_ms), so ms_back_to_back also times the call's
    # throughput: STREAM_COPIES calls back to back, each on its own copy of
    # the table, so that every call reads its rows from HBM.
    shapes = []
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(1), flush=flush)
    tables = {rows: torch.randn(rows, D, device=dev, generator=g) for rows in (20000, 10000)}
    copies = {rows: [t.clone() for _ in range(STREAM_COPIES)] for rows, t in tables.items()}
    cases = []
    for rows in (20000, 10000):
        keys = torch.randint(0, 2 ** 32, (B * T, 2), device=dev, generator=g)
        cases.append((rows, hash_embed_ids(keys, 12345, rows), "uniform", "serving",
                      1 if rows == 20000 else 3))
    keys = torch.randint(0, 2 ** 32, (T, 2), device=dev, generator=g)
    cases.append((20000, hash_embed_ids(keys, 12345, 20000), "uniform", "one-request", 1))
    cases.append((20000, hash_embed_ids(corpus_keys(torch), 12345, 20000), "corpus-skewed",
                  "training", 1))
    for rows, ids, kind, dispatch, calls in cases:
        table = tables[rows]
        got = hash_embed_gather_sum(table, ids)
        want = hash_embed_gather_sum_plain(table, ids)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= TOL_K1:
            fail(f"K1 rows={rows} N={ids.shape[0]}: max_abs_err {err} > {TOL_K1}")
        ids_l = ids.long()
        n = ids.shape[0]
        distinct = int(torch.unique(ids).numel())
        bnd, by = bound_ms(distinct * D * 4 + n * D * 4 + n * 16, 3 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "ids": kind, "distinct_rows": distinct,
            "max_abs_err": err, "dispatch": dispatch,
            "ms": time_ms(torch, lambda: hash_embed_gather_sum(table, ids), flush=flush),
            "ms_back_to_back": back_to_back_ms(
                torch, [lambda t=t: hash_embed_gather_sum(t, ids) for t in copies[rows]],
                flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_gather_sum(table, ids)),
            "plain_ms": time_ms(torch, lambda: hash_embed_gather_sum_plain(table, ids),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(ids_l, table, mode="sum"),
                                  flush=flush),
            "bound_ms": bnd, "bound_by": by,
            "bound_ms_all_rows": bound_ms(n * (4 * D * 4 + D * 4 + 16), 3 * n * D,
                                          PEAK_F32_FLOPS)[0],
            "calls_per_dispatch": calls,
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_bound_back_to_back"] = row["bound_ms"] / row["ms_back_to_back"]
        row["timer_floor_ms"] = floor_ms
        emit({"phase": "kernel:hash_embed_gather_sum", **row})
        shapes.append(row)
    results["hash_embed_gather_sum"] = shapes

    # K2: bf16 q/k/v as views of the fused qkv projection, ragged masks with
    # an all-masked batch-padding row, the key extent the trunk passes: the
    # serving shapes, and a training microbatch's (lengths and padding rows
    # as phase_train_kernels builds them; forward and remat recompute)
    shapes = []
    for b, t in ((B, T), (2, 512), (TRAIN_B, TRAIN_T)):
        qkv = torch.randn(b, t, 3 * D, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (x.view(b, t, H, Dh) for x in qkv.split(D, dim=-1))
        lens = (train_lengths() if b == TRAIN_B else
                [t] + [max(t - 29 * i, 1) for i in range(1, b - 1)] + [0])
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        bias, extent = key_padding(mask)
        scale = 1.0 / math.sqrt(Dh)
        o, lse = flash_attention_fwd(q, k, v, bias, scale, extent)
        o2, lse2 = flash_attention_plain(q, k, v, bias, scale)  # every key
        torch.cuda.synchronize()
        if not bool(torch.isfinite(o.float()).all()):
            fail("K2: non-finite output (the all-masked row must stay finite)")
        err = (o.float() - o2.float()).abs().max().item()
        err_lse = (lse - lse2).abs().max().item()
        if not (err <= TOL_K2_O and err_lse <= TOL_K2_LSE):
            fail(f"K2 B={b} T={t}: max_abs_err o {err} (tol {TOL_K2_O}), "
                 f"lse {err_lse} (tol {TOL_K2_LSE})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        amask = bias.to(torch.bfloat16)[:, None, None, :]
        nbytes = 4 * b * t * H * Dh * 2 + b * t * 4 + b * t * H * 4
        flops = 4 * H * Dh * sum(n * n for n in lens)
        bnd, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        dispatch = ("serving" if (b, t) == (B, T) else "training" if b == TRAIN_B else None)
        row = {
            "B": b, "T": t, "H": H, "Dh": Dh, "dtype": "bf16", "max_abs_err": err,
            "lse_max_abs_err": err_lse,
            "ms": time_ms(torch, lambda: flash_attention_fwd(q, k, v, bias, scale, extent)),
            "host_us": host_us(torch, lambda: flash_attention_fwd(q, k, v, bias, scale, extent)),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(q, k, v, bias, scale)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask)),
            "bound_ms": bnd, "bound_by": by, "dispatch": dispatch,
            "calls_per_dispatch": {"serving": 12, "training": 24}.get(dispatch, 0),
        }
        emit({"phase": "kernel:flash_attention_fwd", **row})
        shapes.append(row)
    results["flash_attention_fwd"] = shapes

    # K4: the four trunk weights of one layer at the top bucket's M = B*T
    # (in the kernels line), and at M = 64 (two docs of 32 tokens, where the
    # weight bytes dominate), with bf16 x as the serving path gives it and
    # with f32 x (values that are not bf16-exact); first ragged shapes that
    # take the kernel's guarded edges (K not a multiple of 16, rows not
    # 16-byte aligned), one of them with K split across CTAs
    shapes = []
    for M, K, N in ((37, 50, 70), (20, 770, 70), (129, 771, 136)):
        q8, s = quantize_int8(torch.randn(K, N, device=dev, generator=g))
        x = torch.randn(M, K, device=dev, generator=g)
        for xx in (x, x.to(torch.bfloat16)):
            want = int8_matmul_plain(xx, q8, s)
            err = (int8_weight_matmul(xx, q8, s) - want).abs().max().item()
            ref = want.abs().max().item()
            if not err <= TOL_K4_REL * ref:
                fail(f"K4 ragged M={M} K={K} N={N} x {xx.dtype}: max_abs_err {err} > "
                     f"{TOL_K4_REL} * {ref}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for M, K, N in [(m, k, n) for m in (B * T, 64)
                    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768))]:
        w = torch.randn(K, N, device=dev, generator=g) * 0.02
        q8, s = quantize_int8(w)
        xf = torch.randn(M, K, device=dev, generator=g)  # f32, not bf16-exact
        xb = xf.to(torch.bfloat16)                       # the serving path's input
        x = xb.float()                                   # its values in f32
        errs, refs = [], []
        for xx in (xb, xf):
            got = int8_weight_matmul(xx, q8, s)
            want = int8_matmul_plain(xx, q8, s)
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
            refs.append(want.abs().max().item())
            if not errs[-1] <= TOL_K4_REL * refs[-1]:
                fail(f"K4 K={K} N={N} x {xx.dtype}: max_abs_err {errs[-1]} > "
                     f"{TOL_K4_REL} * {refs[-1]}")
        w_deq = q8.float() * s  # made once: the library call is the product alone
        w_deq_bf16 = w_deq.to(torch.bfloat16)
        # bf16 x and |q8| <= 127: the bf16 tensor cores accumulating in f32
        # compute each product exactly, so the operations count at the bf16
        # peak; the bytes count x in its own type (2 bytes, 4 for f32 x,
        # which takes two products)
        bnd, by = bound_ms(M * K * 2 + K * N + N * 4 + M * N * 4, 2 * M * N * K, PEAK_BF16_FLOPS)
        bnd_f, by_f = bound_ms(M * K * 4 + K * N + N * 4 + M * N * 4, 4 * M * N * K,
                               PEAK_BF16_FLOPS)
        row = {
            "M": M, "K": K, "N": N, "x": "bf16", "max_abs_err": max(errs),
            "max_abs_err_bf16_f32x": errs, "max_abs_ref": refs,
            "k_splits": split_k(M, N, K, n_sm)[0],
            "ms": time_ms(torch, lambda: int8_weight_matmul(xb, q8, s), flush=flush),
            "host_us": host_us(torch, lambda: int8_weight_matmul(xb, q8, s)),
            "ms_f32x": time_ms(torch, lambda: int8_weight_matmul(xf, q8, s), flush=flush),
            "plain_ms": time_ms(torch, lambda: int8_matmul_plain(xb, q8, s), flush=flush),
            "library": "torch.mm (cuBLAS f32) of x's values and the dequantized weight",
            "library_ms": time_ms(torch, lambda: torch.mm(x, w_deq), flush=flush),
            "bf16_mm_ms": time_ms(torch, lambda: torch.mm(xb, w_deq_bf16), flush=flush),
            "bound_ms": bnd, "bound_by": by, "bound_ms_f32x": bnd_f, "bound_by_f32x": by_f,
            "dispatch": "serving" if M == B * T else None,
            "calls_per_dispatch": 12 if M == B * T else 0,
        }
        emit({"phase": "kernel:int8_weight_matmul", **row})
        shapes.append(row)
    results["int8_weight_matmul"] = shapes
    del scratch
    return results


def ulp_diff(torch, a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item())


def trf_param_shapes(torch, train_path=None):
    """The shape of every parameter leaf, built on the CPU: of the trf.cfg
    trunk + tagger (17 tags), without initialising; with ``train_path``, of
    trf.cfg as written, every component's labels collected from that corpus
    as ``train()`` collects them (``Pipeline.initialize``)."""
    from spacy_ray_tpu_torch import Pipeline
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training import corpus  # noqa: F401  (spacy.Corpus.v1)

    if train_path is None:
        nlp = Pipeline.from_config(trf_tagger_config().interpolate(), device="cpu")
        nlp.components["tagger"].labels = list(UD_TAGS)
        return [tuple(p.shape) for p in nlp._build_models().parameters()]
    cfg = trf_full_config()
    cfg["paths"] = {"train": str(train_path), "dev": str(train_path)}
    cfg = cfg.interpolate()
    nlp = Pipeline.from_config(cfg, device="cpu")
    nlp.initialize(registry.resolve(cfg["corpora"]["train"]), seed=0)
    return [tuple(p.shape) for p in nlp.model.parameters()]


def write_udgen_corpus():
    """The pseudo-UD corpus ``train:full`` trains on: 2000 train and 200 dev
    docs (seeds 0 and 1). Returns (train path, dev path)."""
    from spacy_ray_tpu_torch.udgen import write_ud_jsonl

    work = WORK / "udgen"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_ud_jsonl(work / "train.jsonl", 2000, seed=0)
    write_ud_jsonl(work / "dev.jsonl", 200, seed=1)
    return work / "train.jsonl", work / "dev.jsonl"


def phase_train_kernels(torch, full_shapes):
    """The training path's kernels against their plain versions and timed:
    the hash-embed table gradient and the attention backward (K3) at one
    training microbatch's shapes (B 64, T 128: batch_by_words 2000 on this
    corpus takes up to 40 docs of up to 120 words), the fused update (K5)
    over every leaf of the trf + tagger parameter set (``train:trf``) and of
    trf.cfg as written (``full_shapes``, the leaves ``train:full`` updates)."""
    import torch.nn.functional as F

    from spacy_ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain, key_padding,
    )
    from spacy_ray_tpu_torch.ops.fused_update import (
        FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
    )
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.ops.pallas_kernels import (
        hash_embed_table_grad, hash_embed_table_grad_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        scratch.zero_()

    results = {}
    B, T, D, H, Dh = TRAIN_B, TRAIN_T, 768, 12, 64
    lens = train_lengths()

    # hash-embed table gradient: the four tables of one microbatch, with ids
    # as skewed as the training corpus makes them (a 45-word vocabulary, and
    # every batch-padding position hashing the zero key to the same rows),
    # and once with uniform ids
    corpus = corpus_keys(torch, g)
    shapes = []
    for rows, skewed in ((20000, True), (10000, True), (20000, False)):
        n = B * T
        ct = torch.randn(n, D, device=dev, generator=g)
        keys = (corpus if skewed else
                torch.randint(0, 2 ** 32, (n, 2), device=dev, generator=g))
        ids = hash_embed_ids(keys, 777, rows)
        got = hash_embed_table_grad(ct, ids, rows)
        again = hash_embed_table_grad(ct, ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K1 bwd rows={rows}: two runs on the same inputs differ")
        want_cpu = hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows)
        err = (got.cpu() - want_cpu).abs().max().item()
        if not err <= TOL_K1_BWD:
            fail(f"K1 bwd rows={rows}: max_abs_err {err} vs the CPU plain version > {TOL_K1_BWD}")

        ops = device_ops(torch, lambda: hash_embed_table_grad(ct, ids, rows))
        want = hash_embed_table_grad_plain(ct, ids, rows)
        err_card = (got - want).abs().max().item()
        flat = ids.reshape(-1).long()
        nbytes = rows * D * 4 + n * D * 4 + n * 16
        bnd, by = bound_ms(nbytes, 4 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "ids": "corpus-skewed" if skewed else "uniform",
            "longest_segment": int(torch.bincount(ids.reshape(-1).long()).max()),
            "max_abs_err": err, "max_abs_err_vs_card_plain": err_card,
            "ms": time_ms(torch, lambda: hash_embed_table_grad(ct, ids, rows), flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_table_grad(ct, ids, rows)),
            "launches_per_call": sum(n for n, _ in ops.values()),
            "device_ms_by_op": ops,
            "bit_identical_rerun": True,
            "plain_ms": time_ms(torch, lambda: hash_embed_table_grad_plain(ct, ids, rows),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: torch.zeros(rows, D, device=dev).index_add_(
                0, flat, ct.repeat_interleave(4, 0)), flush=flush),
            "bound_ms": bnd, "bound_by": by, "dispatch": "training" if skewed else None,
            "calls_per_dispatch": 0 if not skewed else 1 if rows == 20000 else 3,
        }
        emit({"phase": "kernel:hash_embed_table_grad", **row})
        shapes.append(row)
    results["hash_embed_table_grad"] = shapes

    # K3: q/k/v as views of the fused projection, ragged masks with an
    # all-masked batch-padding row, the key extent the trunk passes; a
    # nonzero lse cotangent on the check shapes, none on the training shape
    # (the trunk drops the lse). The forward (K2) is held against its plain
    # version on the same inputs, f32 included
    shapes = []
    for b, t, dt, with_dlse in ((3, 70, torch.float32, True), (3, 70, torch.bfloat16, True),
                                (B, T, torch.bfloat16, True), (B, T, torch.bfloat16, False)):
        qkv = torch.randn(b, t, 3 * D, device=dev, generator=g).to(dt)
        q, k, v = (x.view(b, t, H, Dh) for x in qkv.split(D, dim=-1))
        bl = lens if b == B else [t, 33, 0]
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(bl, device=dev)[:, None]
        bias, extent = key_padding(mask)
        scale = 1.0 / math.sqrt(Dh)
        o, lse = flash_attention_fwd(q, k, v, bias, scale, extent)
        o2, lse2 = flash_attention_plain(q, k, v, bias, scale)
        fwd_err = ((o.float() - o2.float()).abs().max().item(), (lse - lse2).abs().max().item())
        if not (fwd_err[0] <= TOL_K2_O and fwd_err[1] <= TOL_K2_LSE):
            fail(f"K2 {dt} B={b} T={t}: max_abs_err o, lse {fwd_err}")
        do = torch.randn(b, t, H, Dh, device=dev, generator=g).to(dt)
        dlse = torch.randn(b, t, H, device=dev, generator=g) if with_dlse else None
        got = flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, scale, extent)
        want = flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse, scale)
        again = flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, scale, extent)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"K3 {dt} B={b} T={t}: two runs on the same inputs differ")
        if not all(bool(torch.isfinite(x.float()).all()) for x in got):
            fail("K3: non-finite gradient (the all-masked row must stay finite)")
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(got, want)]
        refs = [y.float().abs().max().item() for y in want]
        rel = grad_rel_errs(got, want, mask.any(dim=1))
        if dt == torch.float32 and not max(errs) <= TOL_K3_F32:
            fail(f"K3 f32 B={b} T={t}: max_abs_err {errs} > {TOL_K3_F32}")
        if dt == torch.bfloat16 and not max(rel["real"] + rel["masked"]) <= TOL_K3_BF16:
            fail(f"K3 bf16 B={b} T={t}: max err relative to max |grad| over the same rows "
                 f"{rel} > {TOL_K3_BF16}")
        row = {"B": b, "T": t, "H": H, "Dh": Dh, "dtype": str(dt).split(".")[-1],
               "dlse": with_dlse, "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
               "max_abs_ref": refs, "rel_err_real_rows": rel["real"],
               "rel_err_masked_rows": rel["masked"], "fwd_max_abs_err_o_lse": fwd_err,
               "bit_identical_rerun": True, "dispatch": None, "calls_per_dispatch": 0}
        if b == B and not with_dlse:
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
            amask = bias.to(dt)[:, None, None, :]
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
            dot = do.transpose(1, 2)
            n_pairs = sum(n * n for n in bl)
            nbytes = 8 * b * t * H * Dh * 2 + b * t * H * 4 + b * t * 4
            bnd, by = bound_ms(nbytes, 8 * H * Dh * n_pairs, PEAK_BF16_FLOPS)
            row.update({
                "ms": time_ms(torch, lambda: flash_attention_bwd(
                    q, k, v, bias, o, lse, do, None, scale, extent)),
                "host_us": host_us(torch, lambda: flash_attention_bwd(
                    q, k, v, bias, o, lse, do, None, scale, extent)),
                "plain_ms": time_ms(torch, lambda: flash_attention_bwd_plain(
                    q, k, v, bias, o, lse, do, None, scale)),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)),
                "bound_ms": bnd, "bound_by": by, "dispatch": "training",
                "calls_per_dispatch": 12,
            })
        emit({"phase": "kernel:flash_attention_bwd", **row})
        shapes.append(row)
    results["flash_attention_bwd"] = shapes

    # K5: every leaf of the trf + tagger parameter set (train:trf) and of
    # trf.cfg as written (train:full: the heads' leaves too, the odd-sized
    # out_b of nA elements among them), Adam as trf.cfg sets it (clip 1.0)
    # and the other branches on the same leaves; the kernels line totals
    # the set train:full updates
    del scratch
    rows = []
    for leaf_set, leaf_shapes in (("trf+tagger", trf_param_shapes(torch)),
                                  ("trf.cfg as written", full_shapes)):
        main_path = leaf_set == "trf.cfg as written"
        n_params = sum(math.prod(sh) for sh in leaf_shapes)
        P = [torch.randn(sh, device=dev, generator=g) for sh in leaf_shapes]
        G = [torch.randn(sh, device=dev, generator=g) * 1e-3 for sh in leaf_shapes]
        M = [torch.randn(sh, device=dev, generator=g) * 1e-4 for sh in leaf_shapes]
        V = [torch.rand(sh, device=dev, generator=g) * 1e-6 for sh in leaf_shapes]
        worst = 0
        worst_abs = 0.0
        for hyper in (FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0),
                      FusedHyper("adam", 0.9, 0.999, 1e-8, 0.0, 0.01, 0.0),
                      FusedHyper("radam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.01)):
            gnorm = global_norm(G)
            sc = step_scalars(hyper, 9, 9, lambda s: 0.001)
            Pk, Mk, Vk = ([x.clone() for x in X] for X in (P, M, V))
            FusedUpdate(hyper).step(Pk, G, Mk, Vk, gnorm, sc)
            for i in range(len(P)):
                want = leaf_math_plain(P[i], G[i], M[i], V[i], gnorm, *sc, hyper=hyper)
                for a, w in zip((Pk[i], Mk[i], Vk[i]), want):
                    worst = max(worst, ulp_diff(torch, a, w))
                    worst_abs = max(worst_abs, (a - w).abs().max().item())
            del Pk, Mk, Vk
        torch.cuda.synchronize()
        if not worst <= MAXULP_K5:
            fail(f"K5 over {leaf_set}: {worst} ulp from leaf_math_plain > {MAXULP_K5}")
        hyper = FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0)
        fused = FusedUpdate(hyper)
        gnorm = global_norm(G)
        sc = step_scalars(hyper, 9, 9, lambda s: 0.001)

        def plain_all():
            for p, gg, m, v in zip(P, G, M, V):
                leaf_math_plain(p, gg, m, v, gnorm, *sc, hyper=hyper)

        lib_params = [p.clone().requires_grad_(True) for p in P]
        for p, gg in zip(lib_params, G):
            p.grad = gg
        lib_opt = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
        bnd, by = bound_ms(28 * n_params, 20 * n_params, PEAK_F32_FLOPS)
        row = {
            "leaf_set": leaf_set, "leaves": len(P), "params": n_params,
            "odd_sized_leaves": sum(math.prod(sh) % 4 != 0 for sh in leaf_shapes),
            "max_ulp": worst, "max_abs_err": worst_abs,
            "ms": time_ms(torch, lambda: fused.step(P, G, M, V, gnorm, sc), reps=10),
            "host_us": host_us(torch, lambda: fused.step(P, G, M, V, gnorm, sc), reps=10),
            "global_norm_ms": time_ms(torch, lambda: global_norm(G), reps=10),
            "plain_ms": time_ms(torch, plain_all, reps=5, warmup=1),
            "library_ms": time_ms(torch, lib_opt.step, reps=10),
            "bound_ms": bnd, "bound_by": by,
            "dispatch": "training" if main_path else None,
            "calls_per_dispatch": 1 if main_path else 0,
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        # the chunks of the table the timed launches ran over
        row["chunks"] = fused._table.shape[0]
        row["scalar_chunks"] = int((fused._table[:, 5] == 0).sum())
        emit({"phase": "kernel:fused_update", **row})
        rows.append(row)
        del P, G, M, V, lib_params, lib_opt
        torch.cuda.empty_cache()
    results["fused_update"] = rows
    return results


def make_texts(n: int, seed: int):
    rng = random.Random(seed)
    lengths = [3, 8, 15, 30, 60, 100, 5, 90, 12, 45, 2, 80]  # words; <= 128 tokens
    texts = []
    for i in range(n):
        words = []
        for _ in range(lengths[i % len(lengths)]):
            words.append(rng.choice(WORDS) if rng.random() > 0.12 else rng.choice(PUNCT))
        texts.append(" ".join(words))
    return texts


def post(port: int, texts, timeout: float = 60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/parse", data=json.dumps({"texts": texts}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


@contextmanager
def plain_kernels():
    """Swap every kernel of the trunk's path for its plain version (used only
    to produce the reference output; the port itself has no such switch)."""
    import spacy_ray_tpu_torch.models.layers as L
    import spacy_ray_tpu_torch.models.transformer as TR
    from spacy_ray_tpu_torch.ops.flash_attention import flash_attention_plain
    from spacy_ray_tpu_torch.ops.int8_matmul import int8_matmul_plain
    from spacy_ray_tpu_torch.ops.pallas_kernels import hash_embed_gather_sum_plain

    def lookup(table, ids):
        flat = ids.reshape(-1, 4)
        return hash_embed_gather_sum_plain(table, flat).reshape(*ids.shape[:-1], -1)

    def attention(q, k, v, keys):  # over every key: the kernels' extent is checked too
        return flash_attention_plain(q, k, v, keys.bias, q.shape[-1] ** -0.5)[0]

    def int8mm(x, q8, scale):
        x2 = x.reshape(-1, x.shape[-1]).float()
        return int8_matmul_plain(x2, q8, scale).reshape(*x.shape[:-1], -1)

    with mock.patch.object(L, "hash_embed_lookup", lookup), \
            mock.patch.object(TR, "masked_attention", attention), \
            mock.patch.object(TR, "int8_matmul", int8mm):
        yield


def trf_tagger_config():
    """configs/trf.cfg with its transformer and tagger blocks as they are and
    the parser and NER heads removed."""
    cfg = trf_full_config()
    cfg["nlp"]["pipeline"] = ["transformer", "tagger"]
    for name in ("parser", "ner"):
        cfg["components"].pop(name)
    return cfg


def trf_full_config():
    """configs/trf.cfg as written: the trunk with the tagger, parser and NER
    heads, its [training] block and score weights."""
    from spacy_ray_tpu_torch import Config

    cfg = Config.from_disk(ROOT / "configs" / "trf.cfg")
    if cfg["nlp"]["pipeline"] != ["transformer", "tagger", "parser", "ner"]:
        fail(f"configs/trf.cfg pipeline = {cfg['nlp']['pipeline']}")
    model = cfg["components"]["transformer"]["model"]
    for key, want in (("width", 768), ("depth", 12), ("n_heads", 12), ("ffn_mult", 4),
                      ("max_len", 512), ("embed_size", 20000)):
        if model[key] != want:
            fail(f"configs/trf.cfg {key} = {model[key]}, expected {want}")
    return cfg


def grad_errs_vs_plain(torch, nlp, params, batch) -> dict:
    """{leaf: max |g - g_plain| / max |g_plain|}: the gradients of one
    microbatch (dropout off) with every kernel and with every kernel swapped
    for its plain version."""
    grads = []
    for plain in (False, True):
        for p in params.values():
            p.grad = None
        if plain:
            with plain_kernels():
                nlp.loss(batch["tokens"], batch["targets"], dropout=0.0)[0].backward()
        else:
            nlp.loss(batch["tokens"], batch["targets"], dropout=0.0)[0].backward()
        grads.append({k: p.grad.detach().clone() for k, p in params.items()})
    return {k: (grads[0][k] - grads[1][k]).abs().max().item()
            / max(grads[1][k].abs().max().item(), 1e-30) for k in params}


def build_model_dir(torch) -> Path:
    """The trf.cfg trunk with the tagger head, random weights from seed 0."""
    from spacy_ray_tpu_torch import Pipeline

    cfg = trf_tagger_config()
    t0 = time.perf_counter()
    nlp = Pipeline.from_config(cfg.interpolate(), device="cuda")
    nlp.initialize(labels={"tagger": UD_TAGS}, seed=0)
    n_params = sum(p.numel() for p in nlp.model.parameters())
    out = WORK / "trf_tagger"
    nlp.to_disk(out)
    emit({"phase": "model", "dir": str(out.relative_to(ROOT)), "params": n_params,
          "seconds": time.perf_counter() - t0})
    del nlp
    torch.cuda.empty_cache()
    return out


def phase_slice(torch, model_dir: Path, precision: str):
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Example

    t0 = time.perf_counter()
    server = build_server([str(model_dir), "--port", "0", "--max-batch", "8",
                           "--max-doc-len", "128", "--precision", precision])
    engine = server.engine
    nlp = engine.nlp
    try:
        _, port = server.start()
        engine.start()
        setup_s = time.perf_counter() - t0
        status, health = get(port, "/healthz")
        if status != 200 or health["status"] != "ok":
            fail(f"/healthz answered {status} {health}")

        texts = make_texts(24, seed=1)
        latencies = []
        answers = []
        lock = threading.Lock()

        def client(batch):
            for ts in batch:
                t = time.perf_counter()
                status, body = post(port, ts)
                with lock:
                    latencies.append(time.perf_counter() - t)
                    answers.append((status, ts, body))

        # 4 sequential single-text requests, then 4 concurrent clients each
        # sending 3 requests of 1-2 texts
        sequential = [[t] for t in texts[:4]]
        concurrent = [[[texts[4 + 5 * c + i]] if i % 2 else texts[4 + 5 * c + i: 6 + 5 * c + i]
                       for i in range(3)] for c in range(4)]
        _cuda.reset_launch_counts()
        client(sequential)
        threads = [threading.Thread(target=client, args=(c,)) for c in concurrent]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()

        n_tokens = 0
        batches = set()
        for status, ts, body in answers:
            if status != 200:
                fail(f"/v1/parse answered {status}: {body}")
            if len(body["docs"]) != len(ts):
                fail(f"/v1/parse returned {len(body['docs'])} docs for {len(ts)} texts")
            for d in body["docs"]:
                if len(d.get("tags", [])) != len(d["tokens"]) or not all(
                        t in UD_TAGS for t in d["tags"]):
                    fail(f"untagged or mis-tagged doc: {d}")
                n_tokens += len(d["tokens"])
            batches.add((body["batch"]["B"], body["batch"]["T"], body["batch"]["occupancy"]))
        need = ["hash_embed_gather_sum", "flash_attention_fwd"]
        if precision == "int8":
            need.append("int8_weight_matmul")
        missing = [k for k in need if launches[k] == 0]
        if missing:
            fail(f"precision={precision}: kernels never launched on the main path: {missing}")

        # trunk output of one batch: kernels vs plain versions, same pipeline
        docs = [nlp.tokenizer(t) for t in texts[:8]]
        batch = nlp.collate([Example.from_gold(d) for d in docs])
        overlay = engine.overlay.overlay
        with torch.inference_mode():
            out_k = nlp.forward(batch["tokens"], overlay)
            with plain_kernels():
                out_p = nlp.forward(batch["tokens"], overlay)
        mask = batch["tokens"].mask
        xk, xp = out_k["transformer"].X[mask], out_p["transformer"].X[mask]
        if not bool(torch.isfinite(xk).all()):
            fail("trunk output is not finite")
        trunk_err = (xk - xp).abs().max().item()
        tags_k = out_k["tagger"].X[mask].argmax(-1)
        tags_p = out_p["tagger"].X[mask].argmax(-1)
        agree = (tags_k == tags_p).float().mean().item()
        if not trunk_err <= TOL_TRUNK:
            fail(f"trunk kernels vs plain: max_abs_err {trunk_err} > {TOL_TRUNK}")
        if agree < 0.95:
            fail(f"tags kernels vs plain agree on only {agree:.3f} of tokens")

        # one forward at the top serving bucket (B=8, T=128): device time
        # with the kernels and with their plain versions, and the host's
        # time to enqueue it
        top = nlp.collate([Example.from_gold(d) for d in docs], pad_batch_to=8,
                          pad_len_to=128)["tokens"]

        def forward():
            nlp.forward(top, overlay)

        with torch.inference_mode():
            forward_ms = time_ms(torch, forward, reps=10)
            forward_enqueue_ms = enqueue_ms(torch, forward)
            with plain_kernels():
                forward_plain_ms = time_ms(torch, forward, reps=10)

        server.request_shutdown()
        rc = server.wait()
        if rc != 0:
            fail(f"serve drain returned {rc}")
        result = {
            "phase": f"slice:{precision}", "precision_label": engine.overlay.label,
            "requests": len(answers), "tokens": n_tokens, "batches_seen": sorted(batches),
            "launches": launches, "latency_p50_ms": percentile(latencies, 0.50) * 1e3,
            "latency_p99_ms": percentile(latencies, 0.99) * 1e3,
            "setup_s": setup_s, "warmed_buckets": len(engine.warmed),
            "trunk_max_abs_err": trunk_err, "trunk_tol": TOL_TRUNK,
            "tag_agreement": agree, "forward_B8_T128_ms": forward_ms,
            "forward_B8_T128_enqueue_ms": forward_enqueue_ms,
            "forward_B8_T128_plain_ms": forward_plain_ms,
        }
        emit(result)
        return result
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine, nlp
        torch.cuda.empty_cache()


def phase_cli(model_dir: Path):
    """The command a user runs, as a subprocess, answering one request."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", str(model_dir),
         "--port", "0", "--max-batch", "2", "--max-doc-len", "32"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    ready = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "ready" in line:
                ready.set()
        ready.set()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        ready.wait(timeout=240)
        ports = [int(l.rsplit(":", 1)[1]) for l in lines if l.startswith("serving on http://")]
        if not ports or proc.poll() is not None:
            fail("serve CLI did not come up:\n" + "\n".join(lines))
        status, body = post(ports[0], ["The old man came back from Paris ."])
        _, health = get(ports[0], "/healthz")
        if status != 200 or not body["docs"][0].get("tags"):
            fail(f"serve CLI answered {status}: {body}")
        if health["kernel_launches"]["flash_attention_fwd"] == 0:
            fail(f"serve CLI ran no attention kernel: {health}")
        proc.terminate()
        rc = proc.wait(timeout=60)
        th.join(timeout=10)
        emit({"phase": "cli", "output": lines, "status": status, "exit": rc,
              "kernel_launches": health["kernel_launches"]})
        if rc != 0:
            fail(f"serve CLI exited {rc} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def serve_once(torch, model_dir: Path):
    """``model_dir`` through the serving entry point for one request."""
    from spacy_ray_tpu_torch.__main__ import build_server

    server = build_server([str(model_dir), "--port", "0", "--max-batch", "2",
                           "--max-doc-len", "128"])
    engine = server.engine
    try:
        _, port = server.start()
        engine.start()
        status, body = post(port, ["the dog sees a green tree in Tokyo"])
        tags = body["docs"][0].get("tags") if status == 200 else None
        if not tags:
            fail(f"best-model did not serve: {status} {body}")
        server.request_shutdown()
        if server.wait() != 0:
            fail("serving best-model did not drain cleanly")
        return {"status": status, "tags": tags}
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine
        torch.cuda.empty_cache()


def phase_train(torch):
    """``train()`` at trf.cfg's full width on a synthetic tagged corpus,
    with the launch counters zeroed just before and read just after."""
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length
    from spacy_ray_tpu_torch.training.loop import train
    from spacy_ray_tpu_torch.util import write_synth_jsonl

    work = WORK / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_synth_jsonl(work / "train.jsonl", 2000, seed=0, min_len=8, max_len=120)
    write_synth_jsonl(work / "dev.jsonl", 200, seed=1, min_len=8, max_len=120)
    cfg = trf_tagger_config()
    cfg["paths"] = {"train": str(work / "train.jsonl"), "dev": str(work / "dev.jsonl")}
    cfg["training"]["max_steps"] = TRAIN_STEPS
    cfg["training"]["eval_frequency"] = TRAIN_EVAL
    out = work / "out"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    nlp, result = train(cfg, out, device="cuda", stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = result.step_losses
    need = ["hash_embed_gather_sum", "hash_embed_table_grad", "flash_attention_fwd",
            "flash_attention_bwd", "fused_update"]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"train: kernels never launched on the training path: {missing}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"train: {len(losses)} step losses, expected {TRAIN_STEPS} finite ones")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        fail(f"train: the loss did not fall (first 5 steps {first}, last 5 {last})")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]
    host_ms = [x * 1e3 for x in result.step_host_seconds]

    # one step split into forward, backward and optimizer: device time by
    # CUDA events, host time to enqueue each part (from an idle card)
    cfg_i = cfg.interpolate()
    nlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}
    optimizer = registry.resolve(cfg_i["training"]["optimizer"])
    opt_state = optimizer.init(params)
    corpus = registry.resolve(cfg_i["corpora"]["train"])
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    batches = []
    for b in batcher(corpus()):
        batches.append(b)
        if len(batches) == 4:
            break
    B_pad = bucket_batch_size(max(len(b) for b in batches))
    T_pad = bucket_length(max(len(eg) for b in batches for eg in b))
    collated = [nlp.collate(b, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
                for b in batches]

    def timed(fn):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1), host

    parts = {"forward": [0.0, 0.0], "backward": [0.0, 0.0], "optimizer": [0.0, 0.0]}
    for rep in range(3):
        for p in params.values():
            p.grad = None if rep == 0 else p.grad.zero_()
        for c in collated[:3]:
            (loss, _), dev_ms, h = timed(lambda: nlp.loss(c["tokens"], c["targets"],
                                                          dropout=0.1, seed=rep))
            if rep:
                parts["forward"][0] += dev_ms / 2
                parts["forward"][1] += h / 2
            _, dev_ms, h = timed(loss.backward)
            if rep:
                parts["backward"][0] += dev_ms / 2
                parts["backward"][1] += h / 2
        grads = {k: p.grad for k, p in params.items()}
        torch._foreach_div_(list(grads.values()), 3.0)
        with torch.no_grad():
            _, dev_ms, h = timed(lambda: optimizer.update(params, grads, opt_state))
        if rep:
            parts["optimizer"][0] += dev_ms / 2
            parts["optimizer"][1] += h / 2

    # one whole step under torch.profiler: device time by kernel, and the
    # share of the step's wall time the card spent idle
    from torch.profiler import ProfilerActivity, profile

    def one_step():
        for p in params.values():
            p.grad.zero_()
        for c in collated[:3]:
            nlp.loss(c["tokens"], c["targets"], dropout=0.1, seed=7)[0].backward()
        grads = {k: p.grad for k, p in params.items()}
        torch._foreach_div_(list(grads.values()), 3.0)
        with torch.no_grad():
            optimizer.update(params, grads, opt_state)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        step_wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    # the attention kernels' device time in the step, by kernel (K2: forward
    # and remat recompute; K3: its two passes)
    attention_ms = {name: sum(dev_us(e) for e in events if name in e.key) / 1e3
                    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    attention_calls = {name: sum(e.count for e in events if name in e.key)
                       for name in attention_ms}
    # the table gradient's kernels (first design: table_grad_vec4; now
    # table_grad_pieces and table_grad_spans), its sort apart
    table_grad = [e for e in events if "table_grad" in e.key]
    update = [e for e in events if "fused_update" in e.key]
    gather = [e for e in events if "gather_sum" in e.key]
    top = sorted(events, key=dev_us, reverse=True)[:15]
    host_ops = sorted((e for e in prof.key_averages()
                       if not str(getattr(e, "device_type", "")).endswith("CUDA")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    profile_row = {
        "step_wall_ms": step_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_wall_ms,
        "attention_kernels_ms": attention_ms, "attention_kernel_calls": attention_calls,
        "table_grad_kernels_ms": sum(dev_us(e) for e in table_grad) / 1e3,
        "table_grad_kernel_calls": sum(e.count for e in table_grad),
        "table_grad_share_of_busy": sum(dev_us(e) for e in table_grad) / 1e3 / busy_ms,
        "fused_update_kernel_ms": sum(dev_us(e) for e in update) / 1e3,
        "gather_sum_kernels_ms": sum(dev_us(e) for e in gather) / 1e3,
        "gather_sum_kernel_calls": sum(e.count for e in gather),
        "top_device_ms": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in top],
        "top_host_self_ms": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                             for e in host_ops],
    }

    # the gradients of one microbatch with every kernel and with every kernel
    # swapped for its plain version, dropout off
    rel = grad_errs_vs_plain(torch, nlp, params, collated[3])
    worst_leaf = max(rel, key=rel.get)
    if not rel[worst_leaf] <= TOL_GRAD:
        fail(f"train: gradient of {worst_leaf} kernels vs plain {rel[worst_leaf]} > {TOL_GRAD}")
    nlp.model.requires_grad_(False)
    del nlp, params, optimizer, opt_state, grads, collated
    torch.cuda.empty_cache()

    served = serve_once(torch, out / "best-model")
    res = {
        "phase": "train:trf", "seconds": seconds, "steps": result.final_step,
        "accumulate_gradient": 3, "group_shapes_B_T": sorted(set(result.step_shapes)),
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_first5_mean": first, "loss_last5_mean": last,
        "dev_tag_acc": [(h["step"], h["other_scores"].get("tag_acc")) for h in result.history],
        "step_ms_median_events": statistics.median(event_ms),
        "step_ms_median_host": statistics.median(host_ms),
        "words_per_s": result.wps, "words": result.words_seen,
        "peak_memory_gb": peak_gb, "launches": launches,
        "step_split_ms_device_host": {k: v for k, v in parts.items()},
        # device work still queued when the host has enqueued the backward
        "backward_device_tail_ms": parts["backward"][0] - parts["backward"][1],
        "step_split_B_T": [B_pad, T_pad], "step_profile": profile_row,
        # kernel time (under the profiler) against the unprofiled step's time
        "device_idle_share_of_step": 1.0 - profile_row["device_busy_ms"]
        / statistics.median(event_ms),
        "grad_max_rel_err": rel[worst_leaf], "grad_worst_leaf": worst_leaf,
        "grad_tol": TOL_GRAD, "best_model_served_tags": served["tags"],
    }
    emit(res)
    return res


def entity_set(actions, lengths, labels):
    """{(row, start, end, label)} of BILUO action ids [B, T]."""
    from spacy_ray_tpu_torch.pipeline.components.ner import action_to_biluo
    from spacy_ray_tpu_torch.pipeline.doc import Doc

    acts = actions.cpu().tolist()
    out = set()
    for i, n in enumerate(lengths):
        tags = [action_to_biluo(a, labels) for a in acts[i][:n]]
        out.update((i, s.start, s.end, s.label) for s in Doc.spans_from_biluo(tags))
    return out


def set_f(a, b) -> float:
    return 1.0 if not a and not b else 2 * len(a & b) / (len(a) + len(b))


def phase_train_full(torch, udgen, full_shapes):
    """``train()`` on configs/trf.cfg as written (tagger, parser and NER over
    the full-width trunk) on the pseudo-UD corpus ``udgen`` (train, dev),
    launch counters zeroed just before and read just after. Fails unless
    the leaves it trained are ``full_shapes``, those K5 was held at."""
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length
    from spacy_ray_tpu_torch.training.loop import train

    work = WORK / "train_full"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = trf_full_config()
    cfg["paths"] = {"train": str(udgen[0]), "dev": str(udgen[1])}
    cfg["training"]["max_steps"] = TRAIN_STEPS
    cfg["training"]["eval_frequency"] = TRAIN_EVAL
    out = work / "out"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    nlp, result = train(cfg, out, device="cuda", stdout_log=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    need = ["hash_embed_gather_sum", "hash_embed_table_grad", "flash_attention_fwd",
            "flash_attention_bwd", "fused_update"]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"train:full: kernels never launched on the training path: {missing}")
    if len(result.step_head_losses) != TRAIN_STEPS:
        fail(f"train:full: {len(result.step_head_losses)} steps' losses, expected {TRAIN_STEPS}")
    head_losses = {}
    for head in ("tagger", "parser", "ner"):
        xs = [step[head] for step in result.step_head_losses]
        if not all(math.isfinite(x) for x in xs):
            fail(f"train:full: loss_{head} is not finite: {xs}")
        first, last = statistics.mean(xs[:5]), statistics.mean(xs[-5:])
        head_losses[head] = {"first5_mean": first, "last5_mean": last, "first": xs[0],
                             "last": xs[-1]}
        if not last <= 2 / 3 * first:
            fail(f"train:full: loss_{head} fell from {first} to only {last} (> 2/3)")
    event_ms = [a.elapsed_time(b) for a, b in result.step_events]
    trained_shapes = [tuple(p.shape) for p in nlp.model.parameters()]
    if trained_shapes != full_shapes:
        fail(f"train:full: trained {len(trained_shapes)} leaves, not the "
             f"{len(full_shapes)} leaves K5 was held at")

    # one microbatch of B 64, T 128 (the corpus's bucket): forward + backward
    # with every head and with the tagger alone (the parser's and the NER's
    # cost in the step), and the gradients of every leaf with the kernels
    # against the plain versions (dropout off)
    from spacy_ray_tpu_torch.registry import registry

    cfg_i = cfg.interpolate()
    corpus = registry.resolve(cfg_i["corpora"]["train"])
    batcher = registry.resolve(cfg_i["training"]["batcher"])
    batch = next(iter(batcher(corpus())))
    B_pad, T_pad = bucket_batch_size(len(batch)), bucket_length(max(len(eg) for eg in batch))
    c = nlp.collate(batch, with_targets=True, pad_batch_to=B_pad, pad_len_to=T_pad)
    nlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}

    def fwd_bwd(targets):
        for p in params.values():
            p.grad = None
        nlp.loss(c["tokens"], targets, dropout=0.1, seed=1)[0].backward()

    split = {}
    for label, targets in (("all_heads", c["targets"]),
                           ("tagger_only", {"tagger": c["targets"]["tagger"]})):
        fwd_bwd(targets)
        dev_ms, host_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            fwd_bwd(targets)
            e1.record()
            host_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            dev_ms.append(e0.elapsed_time(e1))
        # kernel time alone (the events span host-paced gaps)
        ops = device_ops(torch, lambda: fwd_bwd(targets))
        split[label] = {"device_ms": statistics.median(dev_ms),
                        "host_ms": statistics.median(host_ms),
                        "kernel_ms": sum(v[1] for v in ops.values()),
                        "device_ops": sum(v[0] for v in ops.values())}
    rel = grad_errs_vs_plain(torch, nlp, params, c)
    worst_leaf = max(rel, key=rel.get)
    if not rel[worst_leaf] <= TOL_GRAD:
        fail(f"train:full: gradient of {worst_leaf} kernels vs plain {rel[worst_leaf]} > {TOL_GRAD}")
    heads_worst = max((k for k in rel if k.startswith(("parser/", "ner/"))), key=rel.get)
    nlp.model.requires_grad_(False)
    oracle = dict(nlp.components["parser"].oracle_stats)
    n_leaves, n_params = len(params), sum(p.numel() for p in params.values())
    del nlp, params, c
    torch.cuda.empty_cache()

    keys = ("tag_acc", "dep_uas", "dep_las", "ents_f")
    res = {
        "phase": "train:full", "seconds": seconds, "steps": result.final_step,
        "leaves": n_leaves, "params": n_params,
        "group_shapes_B_T": sorted(set(result.step_shapes)), "head_losses": head_losses,
        "dev_scores": [(h["step"], {k: h["other_scores"].get(k) for k in keys})
                       for h in result.history],
        "dev_eval_words_per_s": [h["eval_wps"] for h in result.history],
        "step_ms_median_events": statistics.median(event_ms),
        "step_ms_median_host": statistics.median(x * 1e3 for x in result.step_host_seconds),
        "words_per_s": result.wps, "words": result.words_seen, "oracle": oracle,
        "peak_memory_gb": peak_gb, "launches": launches,
        "microbatch_B_T": [B_pad, T_pad], "fwd_bwd_split_ms": split,
        "heads_cost_ms_kernels": split["all_heads"]["kernel_ms"]
        - split["tagger_only"]["kernel_ms"],
        "heads_cost_device_ops": split["all_heads"]["device_ops"]
        - split["tagger_only"]["device_ops"],
        "heads_cost_ms_device": split["all_heads"]["device_ms"]
        - split["tagger_only"]["device_ms"],
        "heads_cost_ms_host": split["all_heads"]["host_ms"] - split["tagger_only"]["host_ms"],
        "grad_max_rel_err": rel[worst_leaf], "grad_worst_leaf": worst_leaf,
        "grad_heads_max_rel_err": rel[heads_worst], "grad_heads_worst_leaf": heads_worst,
        "grad_tol": TOL_GRAD,
    }
    emit(res)
    return res, out / "last-model"


def phase_slice_full(torch, model_dir: Path, dev_path: Path, auto: dict):
    """``model_dir`` (trained by ``train:full``) served over ``/v1/parse`` at
    ``--precision auto`` with slice:auto's traffic over pseudo-UD dev texts;
    then, for one B 8, T 128 batch, the heads' decodes by graph replay, eager
    on the card, on the CPU and with every kernel swapped for its plain
    version, and their times."""
    import copy

    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.models.parser import (
        decode_biluo, decode_biluo_viterbi, decode_parser, ner_window_features,
    )
    from spacy_ray_tpu_torch.ops import _cuda
    from spacy_ray_tpu_torch.pipeline.doc import Example
    from spacy_ray_tpu_torch.training.corpus import Corpus

    t0 = time.perf_counter()
    server = build_server([str(model_dir), "--port", "0", "--max-batch", "8",
                           "--max-doc-len", "128", "--precision", "auto"])
    engine = server.engine
    nlp = engine.nlp
    try:
        _, port = server.start()
        t_warm = time.perf_counter()
        engine.start()
        warmup_s = time.perf_counter() - t_warm
        graphs = nlp.decode_graphs
        if graphs is None or len(graphs) == 0:
            fail("slice:full: the warmup captured no decode graph")
        capture = {"graphs": len(graphs), "capture_s": graphs.capture_seconds,
                   "warmup_s": warmup_s, "buckets": len(engine.warmed)}
        setup_s = time.perf_counter() - t0

        texts = [" ".join(eg.reference.words) for eg in Corpus(dev_path)()
                 if len(eg.reference.words) <= 100][:24]
        latencies, answers = [], []
        lock = threading.Lock()

        def client(batch):
            for ts in batch:
                t = time.perf_counter()
                status, body = post(port, ts)
                with lock:
                    latencies.append(time.perf_counter() - t)
                    answers.append((status, ts, body))

        sequential = [[t] for t in texts[:4]]
        concurrent = [[[texts[4 + 5 * c + i]] if i % 2 else texts[4 + 5 * c + i: 6 + 5 * c + i]
                       for i in range(3)] for c in range(4)]
        replays0 = graphs.replays
        _cuda.reset_launch_counts()
        client(sequential)
        threads = [threading.Thread(target=client, args=(c,)) for c in concurrent]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        replays = graphs.replays - replays0
        missing = [k for k in ("hash_embed_gather_sum", "flash_attention_fwd") if launches[k] == 0]
        if missing:
            fail(f"slice:full: kernels never launched on the main path: {missing}")
        if replays == 0:
            fail("slice:full: no decode graph was replayed on the main path")
        n_docs = n_with_ents = n_ents = 0
        labels_dep = set(nlp.components["parser"].labels) | {"ROOT"}
        for status, ts, body in answers:
            if status != 200 or len(body["docs"]) != len(ts):
                fail(f"slice:full: /v1/parse answered {status}: {body}")
            for d in body["docs"]:
                n = len(d["tokens"])
                if not (len(d.get("tags", [])) == len(d.get("heads", [])) == len(d.get("deps", []))
                        == n) or not all(0 <= h < n for h in d["heads"]):
                    fail(f"slice:full: doc without tags, heads or deps: {d}")
                if not set(d["deps"]) <= {l.split("||")[0] for l in labels_dep}:
                    fail(f"slice:full: unknown dep labels in {d['deps']}")
                n_docs += 1
                n_with_ents += bool(d.get("ents"))
                n_ents += len(d.get("ents", []))
        if n_ents == 0:
            fail("slice:full: no response carried an entity")

        # one batch at the top bucket (B 8, T 128)
        docs = [nlp.tokenizer(t) for t in texts[:8]]
        tokens = nlp.collate([Example.from_gold(d) for d in docs], pad_batch_to=8,
                             pad_len_to=128)["tokens"]
        overlay = engine.overlay.overlay
        parser, ner = nlp.components["parser"], nlp.components["ner"]
        with torch.inference_mode():
            out_k = nlp.forward(tokens, overlay)
            with plain_kernels():
                out_p = nlp.forward(tokens, overlay)
            X, mask = out_k["transformer"].X, out_k["transformer"].mask
            lengths = mask.sum(1)
            eager = {n: nlp.components[n].device_decode(X, lengths) for n in ("parser", "ner")}
            replay = {n: {k: v.clone() for k, v in
                          graphs.run(n, nlp.components[n], X, lengths).items()}
                      for n in ("parser", "ner")}
            for n in eager:
                for k in eager[n]:
                    if not torch.equal(eager[n][k], replay[n][k]):
                        fail(f"slice:full: {n} {k}: graph replay differs from the eager decode")
            # the same trunk output and head weights decoded on the CPU
            Xc, lc = X.float().cpu(), lengths.cpu()
            up_p = copy.deepcopy(parser.model.upper).cpu()
            up_n = copy.deepcopy(ner.model.upper).cpu()
            heads_c, labels_c = decode_parser(up_p, Xc, lc, len(parser.labels))
            ner_fn = decode_biluo_viterbi if ner.decode == "viterbi" else decode_biluo
            acts_c = ner_fn(up_n.step_logits(Xc, ner_window_features(128, lc)), lc,
                            len(ner.labels))
        real = mask.cpu()

        def agree(a, b):
            return (a.cpu()[real] == b.cpu()[real]).float().mean().item()

        cpu_agree = {"heads": agree(eager["parser"]["heads"], heads_c),
                     "labels": agree(eager["parser"]["labels"], labels_c),
                     "biluo_actions": agree(eager["ner"]["actions"], acts_c)}
        if min(cpu_agree.values()) < 0.99:
            fail(f"slice:full: card and CPU decodes agree only {cpu_agree} (< 0.99)")
        lens = lengths.tolist()
        plain_agree = {
            "heads": agree(out_k["parser"]["heads"], out_p["parser"]["heads"]),
            "ents_f": set_f(entity_set(out_k["ner"]["actions"], lens, ner.labels),
                            entity_set(out_p["ner"]["actions"], lens, ner.labels)),
        }
        if plain_agree["heads"] < 0.95 or plain_agree["ents_f"] < 0.95:
            fail(f"slice:full: kernels vs plain versions agree only {plain_agree} (< 0.95)")

        # the decodes' device and host-enqueue times at B 8, T 128, as a graph
        # replay and eagerly, and the device operations of each
        decode_times = {}
        with torch.inference_mode():
            for n in ("parser", "ner"):
                comp = nlp.components[n]

                def run_graph():
                    graphs.run(n, comp, X, lengths)

                def run_eager():
                    comp.device_decode(X, lengths)

                ops_g, ops_e = device_ops(torch, run_graph), device_ops(torch, run_eager)
                # spin_cap_s 1.0: the eager decode takes ~105 ms to enqueue, past the
                # default 50 ms cap, and its device time must not count host pacing
                decode_times[n] = {
                    "graph_ms": time_ms(torch, run_graph, reps=10, spin_cap_s=1.0),
                    "graph_enqueue_ms": enqueue_ms(torch, run_graph),
                    "eager_ms": time_ms(torch, run_eager, reps=5, spin_cap_s=1.0),
                    "eager_enqueue_ms": enqueue_ms(torch, run_eager, reps=5),
                    "device_ops_graph": sum(v[0] for v in ops_g.values()),
                    "device_ops_eager": sum(v[0] for v in ops_e.values()),
                    "device_ops_eager_ms": sum(v[1] for v in ops_e.values()),
                    "top_ops_eager": sorted(ops_e.items(), key=lambda kv: -kv[1][0])[:8],
                }

            def forward_graphs():
                nlp.forward(tokens, overlay, graphs)

            # spin_cap_s 1.0: the trunk's enqueue outlasts the default cap, as above
            forward = {"ms": time_ms(torch, forward_graphs, reps=10, spin_cap_s=1.0),
                       "enqueue_ms": enqueue_ms(torch, forward_graphs)}

        server.request_shutdown()
        rc = server.wait()
        if rc != 0:
            fail(f"slice:full: serve drain returned {rc}")
        result = {
            "phase": "slice:full", "precision_label": engine.overlay.label,
            "requests": len(answers), "docs": n_docs, "docs_with_ents": n_with_ents,
            "ents": n_ents, "batches_seen": sorted({(b["batch"]["B"], b["batch"]["T"],
                                                     b["batch"]["occupancy"])
                                                    for _, _, b in answers}),
            "launches": launches, "graph_replays": replays,
            "latency_p50_ms": percentile(latencies, 0.50) * 1e3,
            "latency_p99_ms": percentile(latencies, 0.99) * 1e3,
            "auto_latency_p50_ms": auto["latency_p50_ms"],
            "auto_latency_p99_ms": auto["latency_p99_ms"],
            "setup_s": setup_s, "capture": capture,
            "graph_equals_eager": True, "card_vs_cpu_agreement": cpu_agree,
            "kernels_vs_plain": plain_agree, "decode_B8_T128": decode_times,
            "forward_B8_T128_with_graphs": forward,
        }
        emit(result)
        return result
    finally:
        if engine.ready:
            engine.stop()
        if server._serve_thread is not None and server._serve_thread.is_alive():
            server.httpd.shutdown()
        server.httpd.server_close()
        del server, engine, nlp
        torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "spacy_ray_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no spacy_ray_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from spacy_ray_tpu_torch.devices import resolve_device
    from spacy_ray_tpu_torch.ops import _cuda

    resolve_device("cuda")
    t = time.perf_counter()
    per_source = _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t, "per_source_s": per_source,
          "flags": " ".join(_cuda.NVCC_FLAGS),
          "ptxas": {src: ptxas_summary(_cuda.BUILD_LOGS.get(src, ""))
                    for src in ("flash_attention.cu", "flash_attention_bwd.cu",
                                "int8_matmul.cu", "hash_embed_grad.cu", "hash_embed.cu")}})
    # K5 is 24 instantiations (its branches): the main path's (Adam with
    # clipping: <1,0,0,0>) in full, the rest as their worst
    update = ptxas_summary(_cuda.BUILD_LOGS.get("fused_update.cu", ""))
    emit({"phase": "build", "ptxas": {"fused_update.cu": {
        "main_path": [r for r in update if r["kernel"] == "fused_update<1,0,0,0>"],
        "instantiations": len(update),
        "max_registers": max((r.get("registers", 0) for r in update), default=None),
        "spill_bytes": sum(r["spill_stores"] + r["spill_loads"] for r in update)}}})

    kernels = phase_kernels(torch)
    udgen = write_udgen_corpus()
    full_shapes = trf_param_shapes(torch, udgen[0])
    kernels.update(phase_train_kernels(torch, full_shapes))

    if WORK.exists():
        shutil.rmtree(WORK / "trf_tagger", ignore_errors=True)
    model_dir = build_model_dir(torch)
    runs = {p: phase_slice(torch, model_dir, p) for p in ("auto", "int8")}
    phase_cli(model_dir)
    shutil.rmtree(model_dir, ignore_errors=True)
    runs["train"] = phase_train(torch)
    shutil.rmtree(WORK / "train", ignore_errors=True)
    runs["train:full"], full_model = phase_train_full(torch, udgen, full_shapes)
    runs["slice:full"] = phase_slice_full(torch, full_model, udgen[1], runs["auto"])
    shutil.rmtree(WORK / "train_full", ignore_errors=True)
    shutil.rmtree(WORK / "udgen", ignore_errors=True)

    meta = {
        "hash_embed_gather_sum": ("spacy_ray_tpu_torch/csrc/hash_embed.cu",
                                  "spacy_ray_tpu/ops/pallas_kernels.py:59"),
        "flash_attention_fwd": ("spacy_ray_tpu_torch/csrc/flash_attention.cu",
                                "spacy_ray_tpu/ops/flash_attention.py:63"),
        "int8_weight_matmul": ("spacy_ray_tpu_torch/csrc/int8_matmul.cu",
                               "spacy_ray_tpu/ops/int8_matmul.py:148"),
        "hash_embed_table_grad": ("spacy_ray_tpu_torch/csrc/hash_embed_grad.cu",
                                  "spacy_ray_tpu/ops/pallas_kernels.py:40"),
        "flash_attention_bwd": ("spacy_ray_tpu_torch/csrc/flash_attention_bwd.cu",
                                "spacy_ray_tpu/ops/flash_attention.py:82"),
        "fused_update": ("spacy_ray_tpu_torch/csrc/fused_update.cu",
                         "spacy_ray_tpu/ops/fused_update.py:135"),
    }
    per_table = ("hash_embed_gather_sum", "hash_embed_table_grad")
    totals_for = {
        "serving": "one serving dispatch at B 8, T 128",
        "training": "one training microbatch at B 64, T 128",
    }
    line = []
    for name, (source, replaces) in meta.items():
        # one serving dispatch at B=8, T=128 (K1, K2, K4) or one training
        # microbatch at B=64, T=128 (K1 bwd, K3; one optimizer step for K5):
        # the shapes weighted by calls (K1 and its gradient: 1 NORM + 3 other
        # tables; K2, K3, K4: one layer's calls)
        dispatch = "training" if name in ("hash_embed_table_grad", "flash_attention_bwd",
                                          "fused_update") else "serving"
        rows = [r for r in kernels[name] if r["dispatch"] == dispatch]
        w = {id(r): (r["calls_per_dispatch"] if name in per_table else 1) for r in rows}

        def total(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(w[id(r)] * r[key] for r in rows)

        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(runs[p]["launches"][name] for p in runs),
            "max_abs_err": max(r["max_abs_err"] for r in kernels[name]),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": rows[0]["bound_by"], "library_ms": total("library_ms"),
            "totals_for": totals_for[dispatch] + (
                " (one optimizer step over trf.cfg's leaves)" if name == "fused_update" else ""),
            "shapes": kernels[name],
        })
    emit({"kernels": line})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
