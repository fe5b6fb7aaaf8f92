"""The port stands alone: no jax, no JAX package, and no silent CPU run."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.training.pretrain import pretrain

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "spacy_ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "spacy_ray_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in PORT_FILES if p.name != "chip_smoke.py"
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    cfg = P.Config.from_str('[nlp]\npipeline = []\n')
    nlp = P.Pipeline.from_config(cfg, device="cpu")
    nlp.initialize()
    nlp.to_disk(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt_cfg = P.Config.from_str('[nlp]\npipeline = []\n[pretraining]\nmax_steps = 1\n')
    for build in (lambda: P.Pipeline.from_config(cfg),
                  lambda: P.Pipeline.from_config(cfg, device="cuda"),
                  lambda: P.Pipeline.from_disk(tmp_path),
                  lambda: pretrain(pt_cfg, tmp_path / "pretrain")):
        with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
            build()
    assert P.Pipeline.from_disk(tmp_path, device="cpu").device.type == "cpu"


def test_serve_cli_without_a_card_fails_instead_of_using_the_cpu(tmp_path):
    nlp = P.Pipeline.from_config(P.Config.from_str('[nlp]\npipeline = []\n'), device="cpu")
    nlp.initialize()
    nlp.to_disk(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", str(tmp_path), "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "serving on" not in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card_or_the_package(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_the_serving_modules_of_one_process_are_checked():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {f"spacy_ray_tpu_torch/{m}.py" for m in (
        "serving/multimodel/__init__", "serving/multimodel/registry",
        "serving/multimodel/admission", "serving/multimodel/residency",
        "serving/live/__init__", "serving/live/watcher", "training/resilience")} <= names
    # the trainer fleet's core, its membership, its compressed wire and its
    # optimizer parts are ported, and so are the serving fleet, its placement,
    # the live rollout and the trace collector (their files import neither
    # jax nor the JAX package: test_no_jax_or_jax_package_import covers every
    # file here)
    assert {f"spacy_ray_tpu_torch/training/fleet/{m}.py" for m in (
        "__init__", "ownership", "wire", "peer", "worker", "coordinator",
        "membership")} <= names
    assert {f"spacy_ray_tpu_torch/serving/fleet/{m}.py" for m in (
        "__init__", "replica", "router", "autoscaler", "fleet")} <= names
    assert {f"spacy_ray_tpu_torch/serving/{m}.py" for m in (
        "multimodel/placement", "live/canary", "live/controller", "live/orchestrator",
        "tracecollect")} <= names


def test_the_fleet_wire_quantizes_with_the_ports_own_int8_functions():
    # the compressed wire's int8 codec is the port's copy of the JAX package's
    # host quantizer (ops/int8_matmul.py), imported relatively; importing the
    # wire alone loads it and nothing of JAX
    wire = REPO / "spacy_ray_tpu_torch" / "training" / "fleet" / "wire.py"
    names = {(node.level, node.module, a.name)
             for node in ast.walk(ast.parse(wire.read_text(encoding="utf8")))
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert {(3, "ops.int8_matmul", "quantize_int8_np"),
            (3, "ops.int8_matmul", "dequantize_int8_np")} <= names
    code = ("import sys, spacy_ray_tpu_torch.training.fleet.wire as w\n"
            "print('spacy_ray_tpu_torch.ops.int8_matmul' in sys.modules, w.WIRE_CODECS, "
            f"sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True ('f32', 'bf16', 'int8', 'delta') []"


def test_the_fleet_resume_path_uses_the_ports_own_modules():
    # the optimizer parts, their route, the supervisor and the shutdown
    # coordinator come from the port's own modules, imported relatively; the
    # coordinator and the supervisor load neither torch's card nor JAX
    def relative(path):
        tree = ast.parse((REPO / "spacy_ray_tpu_torch" / path).read_text(encoding="utf8"))
        return {(node.module, a.name) for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level > 0 for a in node.names}

    assert {("checkpoint", "commit_fleet_generation"), ("checkpoint", "write_fleet_opt_part"),
            ("ownership", "local_opt_from_canonical"), ("ownership", "opt_part_records")} <= \
        {((m or "").rsplit(".", 1)[-1], n) for m, n in relative("training/fleet/worker.py")}
    assert ("resilience", "retry_io") in relative("training/checkpoint.py")
    assert ("training.checkpoint", "opt_file_names") in relative("serving/live/watcher.py")
    assert ("resilience", "ShutdownCoordinator") in relative("training/loop.py")
    assert ("resilience", "Supervisor") in relative("training/fleet/coordinator.py")
    code = ("import sys\n"
            "import spacy_ray_tpu_torch.training.fleet.coordinator as c\n"
            "from spacy_ray_tpu_torch.training.resilience import Supervisor\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}), 'torch.cuda' in sys.modules and "
            "sys.modules['torch.cuda'].is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"


def test_serve_with_a_manifest_without_a_card_fails_instead_of_using_the_cpu(tmp_path):
    nlp = P.Pipeline.from_config(P.Config.from_str('[nlp]\npipeline = []\n'), device="cpu")
    nlp.initialize()
    nlp.to_disk(tmp_path / "m")
    (tmp_path / "manifest.json").write_text('{"models": {"m": {"path": "m"}}}')
    out = subprocess.run(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", "x", "--port", "0",
         "--model-manifest", str(tmp_path / "manifest.json"), "--watch", str(tmp_path / "w")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "serving on" not in out.stdout


def test_serve_fleet_without_a_card_fails_before_spawning_a_replica(tmp_path):
    # the router process imports the fleet's modules alone (no JAX), and with
    # --device cuda (the default) on a machine without a card it exits before
    # it binds its port or spawns a replica, instead of crash-looping them
    code = ("import sys, spacy_ray_tpu_torch.serving.fleet as f\n"
            "import spacy_ray_tpu_torch.serving.live, spacy_ray_tpu_torch.serving.tracecollect\n"
            "import spacy_ray_tpu_torch.serving.multimodel.placement\n"
            "from spacy_ray_tpu_torch.training.telemetry import merge_serving_snapshots\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    nlp = P.Pipeline.from_config(P.Config.from_str('[nlp]\npipeline = []\n'), device="cpu")
    nlp.initialize()
    nlp.to_disk(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve-fleet", str(tmp_path), "--port", "0",
         "--replicas", "2", "--verbose"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "replica-spawn" not in out.stderr and "fleet serving on" not in out.stdout


def test_train_and_serve_without_a_card_fails_before_spawning_anything(tmp_path):
    # the trainer's device and the replicas' are both checked before the
    # training process starts; --serve-device cpu alone does not help a
    # trainer on the card
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    for extra in ([], ["--serve-device", "cpu"], ["--device", "cpu", "--serve-device", "cuda"]):
        out = subprocess.run(
            [sys.executable, "-m", "spacy_ray_tpu_torch", "train-and-serve", "configs/cnn.cfg",
             "--output", str(tmp_path / "out"), "--port", "0", *extra],
            cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 1, (extra, out.stderr)
        assert "train-and-serve: no CUDA device is available" in out.stderr
        assert "training pid" not in out.stdout and not (tmp_path / "out").exists()


def test_the_trainer_telemetry_and_resilience_modules_are_checked():
    """The modules of the trainer's telemetry and resilience, and those that
    hold their sites, are among the files the checks above read."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("telemetry.py", "telemetry_http.py", "resilience.py", "loggers.py", "loop.py",
                "corpus.py", "checkpoint.py", "fleet/worker.py", "fleet/peer.py",
                "fleet/wire.py"):
        assert f"spacy_ray_tpu_torch/training/{rel}" in checked
