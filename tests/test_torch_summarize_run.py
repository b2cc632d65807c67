"""`posecnn_torch/cli/summarize_run.py` against `experiments/summarize_run.py`:
the same stdout, byte for byte, on fabricated run directories.

Each script runs in a child process whose working directory holds the
run's `output/` tree, as the scripts read their evaluation files from
there. Neither imports JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_run(root, iters, keys, eval_dirs):
    """metrics.jsonl under root/output/run with rows at `iters` holding
    `keys` (seeded values), and an eval.json in each of `eval_dirs`."""
    rng = np.random.RandomState(3)
    run = os.path.join(root, "output", "run")
    os.makedirs(run)
    with open(os.path.join(run, "metrics.jsonl"), "w") as f:
        for it in iters:
            row = {k: float(rng.rand() * 10) for k in keys}
            row["iter"] = it
            f.write(json.dumps(row) + "\n\n")  # blank lines are skipped
    for name in eval_dirs:
        path = os.path.join(root, "output", name)
        os.makedirs(path)
        with open(os.path.join(path, "eval.json"), "w") as f:
            json.dump({"seg_mean_iou": float(rng.rand()), "adds_auc": float(rng.rand()),
                       "add_auc": float(rng.rand()), "per_class": {}}, f)
    return run


def run_both(root, run_dir):
    env = {**os.environ, "PYTHONPATH": REPO}
    jax_out = subprocess.run([sys.executable, os.path.join(REPO, "experiments", "summarize_run.py"),
                              run_dir], cwd=root, env=env, capture_output=True, timeout=60)
    port_out = subprocess.run([sys.executable, "-m", "posecnn_torch.cli.summarize_run", run_dir],
                              cwd=root, env=env, capture_output=True, timeout=60)
    assert jax_out.returncode == 0, jax_out.stderr.decode()
    assert port_out.returncode == 0, port_out.stderr.decode()
    return jax_out.stdout, port_out.stdout


ALL_KEYS = ("loss", "loss_cls", "loss_vertex", "loss_pose", "lr")
CASES = {
    # a long run, shuffled rows, evaluations in the r2 naming
    "eval_syn": (list(np.random.RandomState(0).permutation(np.arange(0, 4000, 20))), ALL_KEYS,
                 ("eval_syn_1000", "eval_syn_500", "eval_syn_4000")),
    # both namings: the r3 one wins
    "r3_wins": (list(range(0, 60, 10)), ALL_KEYS,
                ("eval_syn_20", "r3_eval_syn_40", "r3_eval_syn_10")),
    # a run without a pose head and no evaluation: loss_pose is nan
    "no_pose_no_eval": (list(range(1, 4)), ("loss", "loss_cls", "loss_vertex", "lr"), ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stdout_equals_the_jax_scripts(case, tmp_path):
    iters, keys, eval_dirs = CASES[case]
    run = write_run(str(tmp_path), [int(i) for i in iters], keys, eval_dirs)
    want, got = run_both(str(tmp_path), run)
    assert got == want
    summary = json.loads(got.decode().splitlines()[-1])
    assert summary["metric"] == "train_run_summary"
    assert len(summary["evals"]) == (2 if case == "r3_wins" else len(eval_dirs))
