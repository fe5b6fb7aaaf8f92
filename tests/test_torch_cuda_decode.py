"""The heads' decodes on the card: CUDA-graph replay against the eager
decode, the beam against its CPU run, and the fused update (K5) over the
full pipeline's leaves, the heads' odd-sized ones included.

Every test here needs an NVIDIA card, carries the ``cuda`` marker and skips
without one. The file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_decode.py

The graph replays the same kernels on the same inputs as the eager decode:
its integers must be equal. The beam sorts stably on both devices; on the
same inputs and weights its integers must be equal too. K5: 0 ulp against
its plain version.
"""

import copy
from pathlib import Path

import pytest
import torch

import spacy_ray_tpu_torch as P
from chip_smoke import ulp_diff
from spacy_ray_tpu_torch.models.parser import decode_parser_beam
from spacy_ray_tpu_torch.ops.fused_update import (
    FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
)
from spacy_ray_tpu_torch.pipeline.decode_graph import DecodeGraphs

REPO = Path(__file__).resolve().parent.parent
DEPS = ["ROOT", "amod", "case", "compound", "det", "nmod", "nmod||nsubj", "nmod||obj",
        "nsubj", "obj", "punct", "vocative"]
ENTS = ["GPE", "ORG", "PERSON", "WORK_OF_ART"]
BUCKETS = [(1, 16), (2, 32), (4, 64), (8, 128)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _pipeline(dev, width=768):
    """configs/trf.cfg's pipeline at ``width`` (depth 1), labels given."""
    cfg = P.Config.from_disk(REPO / "configs" / "trf.cfg")
    cfg["components"]["transformer"]["model"].update(width=width, depth=1, n_heads=width // 64)
    for name in ("tagger", "parser", "ner"):
        cfg["components"][name]["model"]["tok2vec"]["width"] = width
    nlp = P.Pipeline.from_config(cfg.interpolate(), device=dev)
    nlp.initialize(labels={"tagger": ["DT", "NN", "VBD"], "parser": DEPS, "ner": ENTS}, seed=0)
    return nlp


def _inputs(dev, g, B, T, width):
    X = torch.randn(B, T, width, device=dev, generator=g)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=g)
    lengths[0] = T
    if B > 2:
        lengths[-1] = 0  # a batch-padding row
    return X, lengths


@pytest.mark.cuda
def test_graph_replay_equals_eager_decode_at_several_buckets():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    nlp = _pipeline(dev, width=128)
    graphs = DecodeGraphs()
    with torch.inference_mode():
        for decode in ("viterbi", "greedy"):
            nlp.components["ner"].decode = decode
            for B, T in BUCKETS:
                for _ in range(2):  # the capture's inputs, then new ones
                    X, lengths = _inputs(dev, g, B, T, 128)
                    for name in ("parser", "ner"):
                        comp = nlp.components[name]
                        eager = comp.device_decode(X, lengths)
                        replay = {k: v.clone() for k, v in
                                  graphs.run(name, comp, X, lengths).items()}
                        for key in eager:
                            assert torch.equal(replay[key], eager[key]), (name, decode, B, T)
    # one graph per bucket for the parser and for each NER decode; every run replays
    assert len(graphs) == 3 * len(BUCKETS) and graphs.replays == 2 * len(BUCKETS) * 2 * 2


@pytest.mark.cuda
def test_beam_decode_on_the_card_equals_its_cpu_run():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    nlp = _pipeline(dev, width=128)
    upper = nlp.components["parser"].model.upper
    upper_cpu = copy.deepcopy(upper).cpu()
    with torch.inference_mode():
        for B, T in BUCKETS[:3]:
            X, lengths = _inputs(dev, g, B, T, 128)
            got = decode_parser_beam(upper, X, lengths, len(DEPS), 4)
            want = decode_parser_beam(upper_cpu, X.cpu(), lengths.cpu(), len(DEPS), 4)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (B, T)


@pytest.mark.cuda
def test_fused_update_over_the_full_pipelines_leaves_bit_equal():
    # every leaf of trf.cfg's pipeline (the heads' out_b has 1 + 4 * 4 or
    # 2 + 2 * 12 elements), as consecutive views of one buffer: most start
    # at an odd float offset
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [tuple(p.shape) for p in _pipeline(dev).model.parameters()]
    assert (17,) in shapes and (26,) in shapes
    total = sum(torch.Size(s).numel() for s in shapes)
    hyper = FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0)
    bufs = [torch.randn(total + 3, device=dev, generator=g) * s for s in (1.0, 0.1, 0.01, 0.01)]
    bufs[3].abs_()
    leaves = ([], [], [], [])
    for X, buf, start in zip(leaves, bufs, (0, 1, 2, 3)):
        o = start
        for s in shapes:
            n = torch.Size(s).numel()
            X.append(buf[o:o + n].view(s))
            o += n
    Pl, G, M, V = leaves
    gn = global_norm(G)
    sc = step_scalars(hyper, 3, 3, lambda s: 0.001)
    want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper) for p, gg, m, v in zip(Pl, G, M, V)]
    FusedUpdate(hyper).step(Pl, G, M, V, gn, sc)
    for got, w in zip(zip(Pl, M, V), want):
        for a, b in zip(got, w):
            assert ulp_diff(torch, a, b) == 0, a.shape
