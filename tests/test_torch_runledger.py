"""The port's run ledger (``spacy_ray_tpu_torch/training/runledger.py``) and
``telemetry ledger`` held against the JAX package's on the CPU.

Every case of JAX's ``tests/test_runledger.py`` runs once with each package
on the same inputs and the results must be equal: normalization (stubs,
default-off labels, parentheticals), ingestion of the committed
``BENCH_SESSION.jsonl`` (read only) and of torn files, the comparability
key, the trust arithmetic, the diff's refusal matrix and verdicts, the
sentry's verdicts, and both commands' output text and exit codes. Beside
them: synthetic histories made from a seed, and run directories of the
port's trainer (one process and a two-worker fleet's ledgers) read as
ledger rows.
"""

import json
import random
from pathlib import Path
from types import SimpleNamespace

import pytest

import spacy_ray_tpu.cli as j_cli
import spacy_ray_tpu.training.runledger as j_rl
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.training.runledger as p_rl

COMMITTED_SESSION = Path(__file__).resolve().parent.parent / "BENCH_SESSION.jsonl"

PKGS = {
    "jax": SimpleNamespace(name="jax", rl=j_rl, telemetry_command=j_cli.telemetry_command),
    "port": SimpleNamespace(name="port", rl=p_rl, telemetry_command=p_cli.telemetry_command),
}


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal.
    Returns the port's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def raises(pkg, fn, *args, **kwargs):
    """The message of the package's ``LedgerError`` that ``fn`` raises."""
    with pytest.raises(pkg.rl.LedgerError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def _rec(**over):
    """A clean cnn_tagger-style session record; override per case."""
    rec = {"name": "cnn_tagger", "metric": "train_words_per_sec_per_chip (CNN tok2vec tagger)",
           "value": 2600.0, "unit": "words/s/chip", "platform": "cpu", "devices": 1,
           "B": 256, "T": 64, "n_reps": 3, "wps_reps": [2574.0, 2600.0, 2626.0],
           "wps_min": 2574.0, "wps_max": 2626.0, "peak_reprobe_ratio": 0.97,
           "contended": False, "recorded_at": "2026-08-01T00:00:00Z"}
    rec.update(over)
    return rec


def _write_session(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records), encoding="utf8")
    return path


# ----------------------------------------------------------------------
# Normalization and ingestion
# ----------------------------------------------------------------------


def test_normalize_skips_stubs_and_valueless_as_jax():
    def run(pkg):
        n = pkg.rl.normalize_record
        return ([n({"skipped": True, "name": "x"}), n({"name": "x", "value": "fast"}),
                 n({"value": 1.0})], n(_rec(), source="s:1"))

    stubs, row = both(run)
    assert stubs == [None, None, None]
    assert row["name"] == "cnn_tagger" and row["value"] == 2600.0 and row["source"] == "s:1"
    assert row["shape"] == {"B": 256, "T": 64, "devices": 1}


def test_default_off_labels_and_parentheticals_are_dropped_as_jax():
    def run(pkg):
        n, key = pkg.rl.normalize_record, pkg.rl.row_key
        old = n(_rec())
        new = n(_rec(fused_update="off (optax chain)", param_shadow="off", flash="off",
                     grad_compression="f32", param_delta_window=0))
        on = n(_rec(fused_update="active (xla)"))
        a, b = n(_rec(flash="active (pallas)")), n(_rec(flash="active (reference)"))
        return new["labels"], key(new) == key(old), key(on) == key(old), \
            a["labels"]["flash"], key(a) == key(b)

    assert both(run) == ({}, True, False, "active", True)


def test_ingest_the_committed_session_as_jax():
    rows, skipped = both(lambda pkg: pkg.rl.ingest_session(COMMITTED_SESSION))
    assert len(rows) > 100 and len({p_rl.row_key(r) for r in rows}) > 10
    assert all(r["name"] and isinstance(r["value"], float) for r in rows)


def test_torn_lines_are_skipped_and_a_missing_file_refused_as_jax(tmp_path):
    sess = tmp_path / "s.jsonl"
    sess.write_text(json.dumps(_rec()) + "\n" + "{'not json\n"
                    + json.dumps(_rec(value=2500.0)) + "\n"
                    + json.dumps(_rec())[:40] + "\n", encoding="utf8")

    def run(pkg):
        rows, skipped = pkg.rl.ingest_session(sess)
        return [r["value"] for r in rows], skipped, \
            raises(pkg, pkg.rl.ingest_session, tmp_path / "absent.jsonl")

    values, skipped, missing = both(run)
    assert values == [2600.0, 2500.0] and skipped == 2 and "cannot read session file" in missing


# ----------------------------------------------------------------------
# Keys and trust arithmetic
# ----------------------------------------------------------------------


def test_row_key_separates_arms_as_jax():
    def run(pkg):
        key = lambda **over: pkg.rl.row_key(pkg.rl.normalize_record(_rec(**over)))  # noqa: E731
        base = key()
        return [key(**o) == base for o in ({"value": 1234.0}, {"grad_compression": "int8"},
                                           {"B": 512}, {"platform": "tpu"})], base

    same, base = both(run)
    assert same == [True, False, False, False]
    assert base == "cnn_tagger|cpu|B=256,T=64,devices=1"


def test_is_clean_dispersion_and_noise_band_as_jax():
    def run(pkg):
        n, rl = pkg.rl.normalize_record, pkg.rl
        clean = n(_rec())
        return ([rl.is_clean(n(_rec(**o))) for o in ({}, {"contended": True},
                                                     {"peak_reprobe_ratio": 0.90},
                                                     {"peak_reprobe_ratio": None})],
                rl.dispersion(clean), rl.noise_band(clean, clean),
                rl.noise_band(clean, n(_rec(peak_reprobe_ratio=0.88))))

    clean, disp, band, wide = both(run)
    assert clean == [True, False, False, True]
    assert disp == pytest.approx(0.02) and band == pytest.approx(p_rl.NOISE_FLOOR)
    assert wide == pytest.approx(0.12)  # a depressed reprobe widens the band to its slack


# ----------------------------------------------------------------------
# diff and regress
# ----------------------------------------------------------------------


def test_diff_refuses_cross_platform_and_flags_mismatches_as_jax():
    def run(pkg):
        n = pkg.rl.normalize_record
        refused = raises(pkg, pkg.rl.diff_rows, n(_rec(platform="cpu")), n(_rec(platform="tpu")))
        d = pkg.rl.diff_rows(n(_rec()), n(_rec(grad_compression="int8", contended=True,
                                               value=2000.0)))
        return refused, d

    refused, d = both(run)
    assert "cross-platform" in refused
    assert "keys differ" in " ".join(d["warnings"]) and "CONTENDED" in " ".join(d["warnings"])


def test_diff_verdict_directions_as_jax():
    def run(pkg):
        n, diff = pkg.rl.normalize_record, pkg.rl.diff_rows
        a = n(_rec())
        secs = dict(unit="seconds/update", wps_reps=None, wps_min=None, wps_max=None)
        s_a, s_b = n(_rec(value=0.5, **secs)), n(_rec(value=0.6, **secs))
        return [diff(a, n(_rec(value=v))) for v in (2080.0, 3120.0, 2522.0)] + \
            [diff(s_a, s_b), diff(s_b, s_a)]

    drop, gain, noise, rise, fall = both(run)
    assert drop["verdict"] == "regressed" and drop["delta_pct"] == pytest.approx(-20.0)
    assert [gain["verdict"], noise["verdict"]] == ["improved", "within-noise"]
    assert [rise["verdict"], fall["verdict"]] == ["regressed", "improved"]


def test_latest_clean_baseline_and_regress_verdicts_as_jax():
    def run(pkg):
        n, rl = pkg.rl.normalize_record, pkg.rl
        rows = [n(_rec(value=2600.0)), n(_rec(value=2550.0)),
                n(_rec(value=1900.0, contended=True))]
        base = rl.latest_clean_baseline(rows, rl.row_key(rows[0]))
        fresh = [n(_rec(value=2080.0)), n(_rec(value=2522.0)),
                 n(_rec(value=2080.0, contended=True, peak_reprobe_ratio=0.85)),
                 n(_rec(name="brand_new_spec")), n(_rec(value=3200.0)),
                 n(_rec(value=1300.0, contended=True))]
        verdicts = rl.regress(fresh, [n(_rec(value=2600.0))])
        return base["value"], verdicts, rl.render_verdicts(verdicts)

    base, verdicts, text = both(run)
    assert base == 2550.0
    assert [v["verdict"] for v in verdicts] == ["regression", "ok", "untrusted", "no-baseline",
                                                "improved", "untrusted"]
    assert verdicts[0]["baseline_value"] == 2600.0
    assert verdicts[0]["delta_pct"] == pytest.approx(-20.0)
    assert "contended" in verdicts[-1]["reason"]  # even a 50% cliff, unconfirmed
    assert text.endswith("6 verdict(s), 1 confirmed regression(s)")


def test_seeded_histories_render_and_judge_as_jax(tmp_path):
    """Synthetic histories from a seed over several keys, platforms and trust
    stamps: every renderer and the sentry's verdicts equal JAX's."""
    rng = random.Random(24)
    recs = []
    for i in range(60):
        recs.append(_rec(
            name=rng.choice(["cnn_tagger", "trf_tagger", "serve_p99"]),
            platform=rng.choice(["cpu", "gpu"]), B=rng.choice([64, 256]),
            value=round(rng.uniform(500.0, 3000.0), 1),
            unit=rng.choice(["words/s/chip", "seconds/update"]),
            peak_reprobe_ratio=rng.choice([0.99, 0.95, 0.9, None]),
            contended=rng.random() < 0.15, wps_min=None, wps_max=None,
            recorded_at=f"2026-09-{1 + i // 3:02d}T00:00:{i % 60:02d}Z",
            grad_compression=rng.choice(["f32", "int8", None])))
    sess = _write_session(tmp_path / "seeded.jsonl", recs)

    def run(pkg):
        rl = pkg.rl
        rows, skipped = rl.ingest_session(sess)
        by_key = {}
        for r in rows:
            by_key.setdefault(rl.row_key(r), []).append(r)
        fresh = [h[-1] for h in by_key.values()]
        pool = [r for h in by_key.values() for r in h[:-1]]
        diffs = []
        for h in by_key.values():
            if len(h) >= 2:
                diffs.append(rl.render_diff(rl.diff_rows(h[0], h[-1], floor=0.1)))
        return (rl.render_rows(rows, skipped=skipped), rl.render_history(rows, "trf_tagger"),
                rl.render_verdicts(rl.regress(fresh, pool)), diffs)

    listing, history, verdicts, diffs = both(run)
    assert listing.startswith("run ledger: 60 records") and diffs
    assert history.startswith("history for 'trf_tagger'")


# ----------------------------------------------------------------------
# The commands: text and exit codes
# ----------------------------------------------------------------------


def _cli(pkg, argv, capsys):
    """(exit code, stdout, stderr) of ``telemetry ledger <argv>``; a parser
    refusal's SystemExit code and its last line, the program's name cut (the
    usage above it wraps at the name's length)."""
    try:
        rc = pkg.telemetry_command(["ledger", *argv])
    except SystemExit as e:
        err = capsys.readouterr().err.strip().splitlines()[-1]
        return e.code, "", err.split("telemetry ledger: ", 1)[-1]
    got = capsys.readouterr()
    return rc, got.out, got.err


def test_regress_exit_codes_and_json_as_jax(tmp_path, capsys):
    sess = _write_session(tmp_path / "session.jsonl",
                          [_rec(value=2580.0, recorded_at="2026-07-01T00:00:00Z"),
                           _rec(value=2600.0)])
    fresh = {name: _write_session(tmp_path / f"{name}.jsonl", [rec]) for name, rec in (
        ("reg", _rec(value=2080.0)), ("ok", _rec(value=2522.0)),
        ("dirty", _rec(value=2080.0, contended=True)))}

    def run(pkg):
        out_json = tmp_path / f"verdict-{pkg.name}.json"
        got = [_cli(pkg, ["regress", "--session", str(sess), "--record", str(fresh["reg"]),
                          "--json-out", str(out_json)], capsys)]
        got += [_cli(pkg, ["regress", "--session", str(sess), "--record", str(fresh[k])],
                     capsys) for k in ("ok", "dirty")]
        payload = json.loads(out_json.read_text(encoding="utf8"))
        return [(rc, out, err.replace(pkg.name, "<pkg>")) for rc, out, err in got], payload

    got, payload = both(run)
    assert [rc for rc, _, _ in got] == [1, 0, 0]
    assert "[REGRESSION]" in got[0][1] and "[UNTRUSTED]" in got[2][1]
    assert payload["verdicts"][0]["verdict"] == "regression"


def test_regress_judges_the_session_tail_as_jax(tmp_path, capsys):
    bad = _write_session(tmp_path / "bad.jsonl",
                         [_rec(value=2600.0), _rec(value=2580.0), _rec(value=2000.0)])
    ok = _write_session(tmp_path / "ok.jsonl", [_rec(value=2600.0), _rec(value=2580.0)])
    empty = _write_session(tmp_path / "empty.jsonl", [])

    def run(pkg):
        return [_cli(pkg, ["regress", "--session", str(s)], capsys) for s in (bad, ok, empty)]

    got = both(run)
    assert [rc for rc, _, _ in got] == [1, 0, 2]
    assert got[2][2] == "no fresh records to judge\n"


def test_diff_selectors_and_refusals_as_jax(tmp_path, capsys):
    sess = _write_session(tmp_path / "session.jsonl", [_rec(value=2600.0), _rec(value=2650.0)])
    plat = _write_session(tmp_path / "plat.jsonl",
                          [_rec(platform="cpu"), _rec(name="tagger_gpu", platform="gpu")])
    fresh = _write_session(tmp_path / "f.jsonl", [_rec(value=2080.0)])

    def run(pkg):
        s = ["--session", str(sess)]
        return [_cli(pkg, argv, capsys) for argv in (
            ["diff", "cnn_tagger@0", "cnn_tagger@-1", *s],
            ["diff", "cnn_tagger@-1", str(fresh), *s],
            ["diff", "cnn_tagger", "tagger_gpu", "--session", str(plat)],
            ["diff", "nope@0", "cnn_tagger", *s],
            ["diff", "cnn_tagger@9", "cnn_tagger", *s],
            ["diff", "cnn_tagger", *s],
        )]

    got = both(run)
    assert [rc for rc, _, _ in got] == [0, 0, 2, 2, 2, 2]
    assert "within-noise" in got[0][1] and "regressed" in got[1][1]
    assert "cross-platform" in got[2][2] and "no ledger rows named 'nope'" in got[3][2]
    assert "bad index '9'" in got[4][2] and "diff takes exactly two selectors" in got[5][2]


def test_list_show_and_a_missing_session_as_jax(tmp_path, capsys):
    sess = _write_session(tmp_path / "s.jsonl", [_rec(), _rec(name="other", value=10.0)])

    def run(pkg):
        return [_cli(pkg, argv, capsys) for argv in (
            ["list", "--session", str(COMMITTED_SESSION)],
            ["list", "cnn_tagger", "--session", str(sess)],
            ["show", "cnn_tagger", "--session", str(sess)],
            ["show", "nope", "--session", str(sess)],
            ["show", "--session", str(sess)],
            ["list", "--session", str(tmp_path / "absent.jsonl")],
            ["bogus", "--session", str(sess)],
        )]

    got = both(run)
    assert [rc for rc, _, _ in got] == [0, 0, 0, 0, 2, 2, 2]
    assert got[0][1].startswith("run ledger:") and "cnn_tagger" in got[0][1]
    assert "other" not in got[1][1] and got[3][1] == "no ledger rows named 'nope'\n"


# ----------------------------------------------------------------------
# The port's run directories as ledger rows
# ----------------------------------------------------------------------


def _one_process_run(root: Path) -> Path:
    """A run directory as the port's trainer leaves it with telemetry on:
    step and eval rows in ``metrics/metrics.jsonl``."""
    rows = [{"kind": "step", "step": s, "step_seconds": 0.01, "words": 100,
             "process": {"rss_peak_bytes": 1000 + s}} for s in range(1, 5)]
    rows += [{"kind": "eval", "step": 2, "wps": 1500.5, "platform": "gpu"},
             {"kind": "eval", "step": 4, "wps": 1712.25, "platform": "gpu",
              "process": {"rss_peak_bytes": 5000}}]
    (root / "metrics").mkdir(parents=True)
    (root / "metrics" / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows), encoding="utf8")
    return root


def _fleet_run(root: Path) -> Path:
    """A two-worker fleet's run directory: the workers' exit ledgers and
    their metrics rows."""
    for k, (words, secs) in enumerate(((12000, 10.0), (11000, 12.5))):
        (root / f"fleet-worker-{k}.json").parent.mkdir(parents=True, exist_ok=True)
        (root / f"fleet-worker-{k}.json").write_text(json.dumps({
            "worker": k, "words_seen": words, "seconds": secs, "grad_compression": "int8",
            "quorum": 2}), encoding="utf8")
        d = root / "metrics" / f"fleet-worker-{k}"
        d.mkdir(parents=True)
        (d / "metrics.jsonl").write_text(json.dumps(
            {"kind": "eval", "step": 4, "wps": 900.0, "platform": "cpu",
             "process": {"rss_peak_bytes": 7000 + k}}) + "\n", encoding="utf8")
    return root


def test_port_run_directories_are_ledger_rows_as_jax(tmp_path, capsys):
    one, fleet = _one_process_run(tmp_path / "one"), _fleet_run(tmp_path / "fleet")
    empty = _write_session(tmp_path / "empty.jsonl", [])

    def run(pkg):
        rows = [pkg.rl.ingest_run_dir(d) for d in (one, fleet)]
        listed = _cli(pkg, ["list", "--session", str(empty), "--run-dir", str(one),
                            "--run-dir", str(fleet)], capsys)
        return rows, listed

    (one_rows, fleet_rows), (rc, out, _) = both(run)
    assert [(r["name"], r["value"], r["platform"]) for r in one_rows] == [
        ("telemetry_run", 1712.25, "gpu")]
    assert one_rows[0]["host"] == {"rss_peak_bytes": 5000}
    assert [(r["name"], r["value"], r["shape"], r["labels"]) for r in fleet_rows] == [
        ("telemetry_run_fleet", 1840.0, {"workers": 2}, {"grad_compression": "int8",
                                                          "quorum": 2})]
    assert rc == 0 and out.startswith("run ledger: 2 records, 2 keys")
