"""Readings that the limits of a serving cell's comparison are set from.

    python3 benchmark/calibrate.py --workload serve_b4.posecnn_ycb \\
        --seeds 11 12 ... --control-seeds 11 12 13 --seconds 2 --out <file.jsonl>

In one process (the engine is built once, each seed's weights, extents and
frames copied in): for every seed a short window at the cell's own load,
then the comparison of the frames it sampled, which gives the program's
readings; for every control seed the same frames served by the reference
in the configuration's precision ("bf16", the witness) and in the nearest
precision below it ("fp8", the control), judged by the same comparison.
Each reading is one JSON line. The limits in `benchmark/limits/` lie
above the program's largest reading and below the control's smallest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import harness  # noqa: E402
from benchmark.reference import judge_serve  # noqa: E402
from benchmark.reference import posecnn as ref  # noqa: E402


def readings(run, seeds, control_seeds, seconds, emit, with_rows=False):
    """Program readings for `seeds`, witness and control readings for
    `control_seeds`; each reading is passed to `emit` as a dict."""
    import torch

    runner = harness.load_module(ROOT / "benchmark" / "runners" / f"{run.traffic['runner']}.py",
                                 "calibrate_runner")
    cell = None
    for seed in dict.fromkeys(list(seeds) + list(control_seeds)):
        t0 = time.perf_counter()
        if cell is None:
            cell = runner.ServeCell(run.config, run.traffic, run.device, seed)
        else:
            cell.load(seed)
        rec = cell.serve(seconds)
        items, unmatched = cell.judge_items(rec["results"])
        extents = torch.from_numpy(cell.extents_np).to(run.device)
        weights = ref.make_weights(ref.param_specs(run.config), seed, run.device)
        if seed in seeds:
            rows = [] if with_rows else None
            nums = judge_serve.judge(weights, run.config, extents, runner.YCB_K, items, rows)
            emit(dict(seed=seed, side="program", frames=len(items), unserved_rows=unmatched, **nums,
                      seconds=time.perf_counter() - t0, **({"rows": rows} if rows else {})))
        if seed in control_seeds:
            images = [it[0] for it in items]
            for precision in ("bf16", "fp8"):
                served = ref.serve_frames(weights, images, extents, runner.YCB_K, run.config,
                                          precision)
                stand_in = [(img, lab, dets) for img, (lab, dets) in zip(images, served)]
                rows = [] if with_rows else None
                nums = judge_serve.judge(weights, run.config, extents, runner.YCB_K, stand_in,
                                         rows)
                emit(dict(seed=seed, side=precision, frames=len(images), **nums,
                          **({"rows": rows} if rows else {})))
        del weights


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    p.add_argument("--rows", action="store_true", help="each detection's readings too")
    args = p.parse_args(argv)
    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    run = harness.make_run(ROOT, args.workload, args.seeds[0], args.seconds, False,
                           torch.device("cuda:0"), time.time(), "")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        def emit(d):
            d = {"workload": args.workload, "kind": torch.cuda.get_device_name(0), **d}
            line = json.dumps(d)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        readings(run, args.seeds, args.control_seeds, args.seconds, emit, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
