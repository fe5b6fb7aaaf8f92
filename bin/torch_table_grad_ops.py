#!/usr/bin/env python3
"""Device operations of one call of the port's hash-embed table gradient.

    cd <checkout> && python3 <path to>/bin/torch_table_grad_ops.py

Profiles one call of ``hash_embed_table_grad`` from the
``spacy_ray_tpu_torch`` package of the current directory, so that two
checkouts (a parent and a change) can be compared in one run, at a training
microbatch's shape (8192 tokens, 768 wide, the 20000-row table) with half
the pairs on one row, as batch padding puts them. Prints one JSON line: the
kernels, copies and fills the call puts on the card, by name with their
count and device ms (``torch.profiler``), and their total count. Needs a
card.
"""

import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spacy_ray_tpu_torch.ops.pallas_kernels import hash_embed_table_grad

    if not torch.cuda.is_available():
        print("torch_table_grad_ops: needs a CUDA card", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    n, d, rows = 8192, 768, 20000
    ct = torch.randn(n, d, device="cuda", generator=g)
    ids = torch.randint(0, rows, (n * 4,), device="cuda", generator=g, dtype=torch.int32)
    ids[torch.randperm(n * 4, device="cuda", generator=g)[: n * 2]] = 3
    ids = ids.reshape(n, 4)
    hash_embed_table_grad(ct, ids, rows)  # builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hash_embed_table_grad(ct, ids, rows)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            ops[e.key[:60]] = [e.count, us / 1e3]
    print(json.dumps({"checkout": os.getcwd(), "device_ops_per_call": sum(c for c, _ in ops.values()),
                      "device_ms_by_op": ops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
