#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

1. card     — ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build    — compiles every kernel of ``spacy_ray_tpu_torch/csrc`` with
              nvcc for sm_90a (one nvcc per source, in parallel).
3. kernel:* — each kernel's wrapper on the card at the serving slice's
              shapes, held against its plain PyTorch version on the same
              inputs (tolerances below), and timed with CUDA events beside
              its plain version, a PyTorch library call computing the same
              function where one exists, and its bound; ``host_us`` is the
              host's time to launch it through its wrapper.
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

# tolerances of kernel vs plain version on the same inputs
TOL_K1 = 0.0        # the same four f32 adds in the same order: bit-equal
TOL_K2_O = 1e-2     # bf16 output: about 1 ulp at |o| ~ 2 (2**-7 = 7.8e-3)
TOL_K2_LSE = 1e-3   # f32 log-sum-exp, different summation order
TOL_K4_REL = 1e-4   # f32 accumulation order, relative to max |out|
TOL_TRUNK = 0.1     # bf16 trunk after 12 layers, max |diff| on real tokens

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


# ----------------------------------------------------------- measurement


def time_ms(torch, fn, *, reps: int = 25, warmup: int = 3, flush=None) -> float:
    """Median milliseconds of one call, each timed with CUDA events; with
    ``flush``, L2 is overwritten before each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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


# ---------------------------------------------------------------- phases


def phase_kernels(torch):
    """Each kernel against its plain version and timed, at slice shapes."""
    import torch.nn.functional as F

    from spacy_ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain, mask_to_bias,
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

    # K1: the four hash tables of one dispatch (NORM 20000, three of 10000)
    shapes = []
    for rows in (20000, 10000):
        table = torch.randn(rows, D, device=dev, generator=g)
        keys = torch.randint(0, 2 ** 32, (B * T, 2), device=dev, generator=g)
        ids = hash_embed_ids(keys, 12345, rows)
        got = hash_embed_gather_sum(table, ids)
        want = hash_embed_gather_sum_plain(table, ids)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= TOL_K1:
            fail(f"K1 rows={rows}: max_abs_err {err} > {TOL_K1}")
        ids_l = ids.long()
        n = B * T
        nbytes = n * (4 * D * 4 + D * 4 + 16)
        bnd, by = bound_ms(nbytes, 3 * n * D, PEAK_F32_FLOPS)
        row = {
            "rows": rows, "D": D, "N": n, "max_abs_err": err,
            "ms": time_ms(torch, lambda: hash_embed_gather_sum(table, ids), flush=flush),
            "host_us": host_us(torch, lambda: hash_embed_gather_sum(table, ids)),
            "plain_ms": time_ms(torch, lambda: hash_embed_gather_sum_plain(table, ids),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(ids_l, table, mode="sum"),
                                  flush=flush),
            "bound_ms": bnd, "bound_by": by, "calls_per_dispatch": 1 if rows == 20000 else 3,
        }
        emit({"phase": "kernel:hash_embed_gather_sum", **row})
        shapes.append(row)
    results["hash_embed_gather_sum"] = shapes

    # K2: bf16 q/k/v as views of the fused qkv projection, ragged masks with
    # an all-masked batch-padding row
    shapes = []
    for b, t in ((B, T), (2, 512)):
        qkv = torch.randn(b, t, 3 * D, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = (x.view(b, t, H, Dh) for x in qkv.split(D, dim=-1))
        lens = [t] + [max(t - 29 * i, 1) for i in range(1, b - 1)] + [0]
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        bias = mask_to_bias(mask)
        scale = 1.0 / math.sqrt(Dh)
        o, lse = flash_attention_fwd(q, k, v, bias, scale)
        o2, lse2 = flash_attention_plain(q, k, v, bias, scale)
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
        row = {
            "B": b, "T": t, "H": H, "Dh": Dh, "dtype": "bf16", "max_abs_err": err,
            "lse_max_abs_err": err_lse,
            "ms": time_ms(torch, lambda: flash_attention_fwd(q, k, v, bias, scale)),
            "host_us": host_us(torch, lambda: flash_attention_fwd(q, k, v, bias, scale)),
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(q, k, v, bias, scale)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask)),
            "bound_ms": bnd, "bound_by": by, "calls_per_dispatch": 12 if t == T else 0,
        }
        emit({"phase": "kernel:flash_attention_fwd", **row})
        shapes.append(row)
    results["flash_attention_fwd"] = shapes

    # K4: the four trunk weights of one layer at the top bucket's M = B*T
    # (in the kernels line), and at M = 64 (two docs of 32 tokens, where the
    # weight bytes dominate); first ragged shapes that take the kernel's
    # unvectorised edges, one of them with K split across CTAs
    shapes = []
    for M, K, N in ((37, 50, 70), (20, 770, 70)):
        x = torch.randn(M, K, device=dev, generator=g)
        q8, s = quantize_int8(torch.randn(K, N, device=dev, generator=g))
        err = (int8_weight_matmul(x, q8, s) - int8_matmul_plain(x, q8, s)).abs().max().item()
        ref = int8_matmul_plain(x, q8, s).abs().max().item()
        if not err <= TOL_K4_REL * ref:
            fail(f"K4 ragged M={M} K={K} N={N}: max_abs_err {err} > {TOL_K4_REL} * {ref}")
    for M, K, N in [(m, k, n) for m in (B * T, 64)
                    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768))]:
        w = torch.randn(K, N, device=dev, generator=g) * 0.02
        q8, s = quantize_int8(w)
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16).float()
        got = int8_weight_matmul(x, q8, s)
        want = int8_matmul_plain(x, q8, s)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        if not err <= TOL_K4_REL * ref:
            fail(f"K4 K={K} N={N}: max_abs_err {err} > {TOL_K4_REL} * {ref}")
        # x holds bf16 values, as on the serving path, and |q8| <= 127, so
        # bf16 tensor cores accumulating in f32 compute this exactly: the
        # operations are counted at the bf16 peak, and the bytes bound it
        if not torch.equal(x, x.to(torch.bfloat16).float()):
            fail("K4: x must hold bf16 values for the bf16 operation bound")
        nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
        bnd, by = bound_ms(nbytes, 2 * M * N * K, PEAK_BF16_FLOPS)
        row = {
            "M": M, "K": K, "N": N, "max_abs_err": err, "max_abs_ref": ref,
            "k_splits": split_k(M, N, K, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)[0],
            "ms": time_ms(torch, lambda: int8_weight_matmul(x, q8, s), flush=flush),
            "host_us": host_us(torch, lambda: int8_weight_matmul(x, q8, s)),
            "plain_ms": time_ms(torch, lambda: int8_matmul_plain(x, q8, s), flush=flush),
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "calls_per_dispatch": 12 if M == B * T else 0,
        }
        emit({"phase": "kernel:int8_weight_matmul", **row})
        shapes.append(row)
    results["int8_weight_matmul"] = shapes
    del scratch
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
    from spacy_ray_tpu_torch.ops.flash_attention import flash_attention_plain, mask_to_bias
    from spacy_ray_tpu_torch.ops.int8_matmul import int8_matmul_plain
    from spacy_ray_tpu_torch.ops.pallas_kernels import hash_embed_gather_sum_plain

    def lookup(table, ids):
        flat = ids.reshape(-1, 4)
        return hash_embed_gather_sum_plain(table, flat).reshape(*ids.shape[:-1], -1)

    def attention(q, k, v, mask):
        return flash_attention_plain(q, k, v, mask_to_bias(mask), q.shape[-1] ** -0.5)[0]

    def int8mm(x, q8, scale):
        x2 = x.reshape(-1, x.shape[-1]).float()
        return int8_matmul_plain(x2, q8, scale).reshape(*x.shape[:-1], -1)

    with mock.patch.object(L, "hash_embed_lookup", lookup), \
            mock.patch.object(TR, "attention", attention), \
            mock.patch.object(TR, "int8_matmul", int8mm):
        yield


def build_model_dir(torch) -> Path:
    """The trf.cfg trunk with the tagger head, random weights from seed 0."""
    from spacy_ray_tpu_torch import Config, Pipeline

    cfg = Config.from_disk(ROOT / "configs" / "trf.cfg")
    cfg["nlp"]["pipeline"] = ["transformer", "tagger"]
    for name in ("parser", "ner"):
        cfg["components"].pop(name)
    model = cfg["components"]["transformer"]["model"]
    for key, want in (("width", 768), ("depth", 12), ("n_heads", 12), ("ffn_mult", 4),
                      ("max_len", 512), ("embed_size", 20000)):
        if model[key] != want:
            fail(f"configs/trf.cfg {key} = {model[key]}, expected {want}")
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
          "flags": " ".join(_cuda.NVCC_FLAGS)})

    kernels = phase_kernels(torch)

    if WORK.exists():
        shutil.rmtree(WORK / "trf_tagger", ignore_errors=True)
    model_dir = build_model_dir(torch)
    runs = {p: phase_slice(torch, model_dir, p) for p in ("auto", "int8")}
    phase_cli(model_dir)
    shutil.rmtree(model_dir, ignore_errors=True)

    meta = {
        "hash_embed_gather_sum": ("spacy_ray_tpu_torch/csrc/hash_embed.cu",
                                  "spacy_ray_tpu/ops/pallas_kernels.py:59"),
        "flash_attention_fwd": ("spacy_ray_tpu_torch/csrc/flash_attention.cu",
                                "spacy_ray_tpu/ops/flash_attention.py:63"),
        "int8_weight_matmul": ("spacy_ray_tpu_torch/csrc/int8_matmul.cu",
                               "spacy_ray_tpu/ops/int8_matmul.py:148"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        # one dispatch at B=8, T=128: the shapes weighted by calls per
        # dispatch per layer (K1: 1 NORM + 3 other tables; K2 and K4: one
        # layer's calls)
        rows = [r for r in kernels[name] if r["calls_per_dispatch"]]
        w = {id(r): (r["calls_per_dispatch"] if name == "hash_embed_gather_sum" else 1)
             for r in rows}

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
