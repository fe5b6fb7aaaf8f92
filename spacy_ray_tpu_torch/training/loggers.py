"""Training loggers: the ``[training.logger]`` block (counterpart of the
console logger of ``spacy_ray_tpu/training/loggers.py``). The factory
returns a setup function taking the pipeline and returning ``(log_step,
finalize)``; ``log_step(info_or_None)`` is called every step, with an info
dict at each evaluation (None = no new row)."""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, IO, List, Optional

from ..registry import registry


def _fmt(value: float, width: int = 8, places: int = 2) -> str:
    return f"{value:{width}.{places}f}"


def _elapsed(seconds: float) -> str:
    s = int(seconds)
    return f"{s // 3600}:{(s % 3600) // 60:02d}:{s % 60:02d}"


@registry.loggers("spacy-ray.ConsoleLogger.v1")
@registry.loggers("spacy_ray_tpu.ConsoleLogger.v1")
def console_logger(progress_bar: bool = False):
    def setup(nlp, stdout: IO = sys.stdout, stderr: IO = sys.stderr):
        pipe_names = [n for n in nlp.head_names() if nlp.components[n].trainable]
        score_keys = list(nlp.config.get("training", {}).get("score_weights", {}) or {})
        if not score_keys:
            from .loop import default_pipeline_score_weights

            score_keys = [k for k, v in default_pipeline_score_weights(nlp).items() if v > 0]
        header = (["T", "E", "#", "W"] + [f"Loss {n}" for n in pipe_names] + score_keys
                  + ["Stp50", "Stp95", "WPS", "EvalS", "Score"])
        widths = [max(len(h), 8) for h in header]
        stdout.write(" ".join(h.rjust(w) for h, w in zip(header, widths)) + "\n")
        stdout.write(" ".join("-" * w for w in widths) + "\n")
        t0 = time.perf_counter()
        eval_freq = int(nlp.config.get("training", {}).get("eval_frequency", 0) or 0)
        pending = 0

        def log_step(info: Optional[Dict[str, Any]]) -> None:
            nonlocal pending
            if info is None:
                if progress_bar and stderr is not None:
                    pending += 1
                    if eval_freq:
                        done = int(20 * pending / eval_freq)
                        stderr.write(f"\r[{'#' * done}{'-' * (20 - done)}] {pending}/{eval_freq}")
                    else:
                        stderr.write(f"\rstep +{pending}")
                    stderr.flush()
                return
            if progress_bar and stderr is not None and pending:
                stderr.write("\r" + " " * 40 + "\r")
                stderr.flush()
            pending = 0
            row: List[str] = [
                _elapsed(time.perf_counter() - t0).rjust(widths[0]),
                str(info.get("epoch", 0)).rjust(widths[1]),
                str(info.get("step", 0)).rjust(widths[2]),
                str(info.get("words", 0)).rjust(widths[3]),
            ]
            losses = info.get("losses", {})
            for i, name in enumerate(pipe_names):
                row.append(_fmt(float(losses.get(name, 0.0)), widths[4 + i]))
            scores = info.get("other_scores", {})
            for j, key in enumerate(score_keys):
                val = scores.get(key)
                col = widths[4 + len(pipe_names) + j]
                row.append(_fmt(float(val) * 100, col) if val is not None else " " * col)
            for j, key in enumerate(("step_ms_p50", "step_ms_p95")):
                val = info.get(key)
                col = widths[-5 + j]
                row.append(_fmt(float(val), col, 1) if val is not None else " " * col)
            row.append(_fmt(float(info.get("wps", 0.0)), widths[-3], 0))
            row.append(_fmt(float(info.get("eval_seconds", 0.0)), widths[-2]))
            score = info.get("score")
            row.append(_fmt(float(score) * 100, widths[-1]) if score is not None
                       else " " * widths[-1])
            stdout.write(" ".join(row) + "\n")
            stdout.flush()

        def finalize() -> None:
            if progress_bar and stderr is not None and pending:
                stderr.write("\r" + " " * 40 + "\r")
                stderr.flush()

        return log_step, finalize

    return setup
