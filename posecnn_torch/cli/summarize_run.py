"""Summarize a training run and its snapshot evaluations in one table.

    python -m posecnn_torch.cli.summarize_run <out_dir>

Counterpart of `experiments/summarize_run.py`, on the port's files: it
reads `<out_dir>/metrics.jsonl` as `cli/train_net.py` writes it (one JSON
object an iteration: `iter`, the loss terms, `lr`) and the `eval.json` of
each `output/r3_eval_syn_<iter>/` or, when there is none,
`output/eval_syn_<iter>/` under the working directory, as `cli/test_net.py`
writes them (`engine/evaluate.PoseEvaluator.summary`: `seg_mean_iou`,
`adds_auc`, `add_auc`). It prints the same markdown tables and the same
`train_run_summary` JSON line as the JAX script, byte for byte. Host
only: it needs no card.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys

import numpy as np


def main(out_dir: str) -> int:
    rows = []
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    rows.sort(key=lambda r: r["iter"])
    # the loss at 8 probes: the median over a ±250-iteration window
    probes = [r["iter"] for r in rows][:: max(1, len(rows) // 8)]
    print("## train loss curve")
    print("| iter | loss (med±500) | loss_cls | loss_vertex | loss_pose | lr |")
    print("|---|---|---|---|---|---|")
    curve = []
    for p in probes:
        win = [r for r in rows if abs(r["iter"] - p) <= 250]

        def med(key):
            return float(np.median([r[key] for r in win if key in r]))

        curve.append({"iter": p, "loss": round(med("loss"), 3)})
        print(
            f"| {p} | {med('loss'):.3f} | {med('loss_cls'):.3f} | "
            f"{med('loss_vertex'):.3f} | {med('loss_pose'):.3f} | {med('lr'):.2e} |"
        )

    evals = []
    # both evaluation-directory namings; the r3_ one wins when both exist
    paths = sorted(glob.glob("output/r3_eval_syn_*/eval.json")) or sorted(
        glob.glob("output/eval_syn_*/eval.json")
    )
    for path in paths:
        m = re.search(r"eval_syn_(\d+)", path)
        with open(path) as f:
            d = json.load(f)
        evals.append(
            {
                "iter": int(m.group(1)),
                "seg_mean_iou": round(d.get("seg_mean_iou", float("nan")), 4),
                "adds_auc": round(d.get("adds_auc", float("nan")), 4),
                "add_auc": round(d.get("add_auc", float("nan")), 4),
            }
        )
    evals.sort(key=lambda e: e["iter"])
    if evals:
        print("\n## held-out synthetic eval curve (30 scenes, seed 4242)")
        print("| iter | seg mean IoU | ADD-S AUC | ADD AUC |")
        print("|---|---|---|---|")
        for e in evals:
            print(f"| {e['iter']} | {e['seg_mean_iou']} | {e['adds_auc']} | {e['add_auc']} |")

    print()
    print(json.dumps({"metric": "train_run_summary", "loss_curve": curve, "evals": evals}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1] if len(sys.argv) > 1 else "output/lov_syn_r2"))
