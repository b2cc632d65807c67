"""`train_net --num_data` and the data-parallel loop, on the CPU over gloo.

- `train_net --num_data 2 --device cpu` spawns 2 ranks, runs 2
  iterations and writes one `metrics.jsonl` and one final snapshot (rank
  0's);
- the rank count: more ranks than cards raise JAX's `needs … devices`
  message from `main`, before any CUDA call; -1 is every card, or one
  process on the CPU; under `--device cpu` any N is N processes;
- the dropout streams: rank 0's are the one-process streams, the other
  ranks' differ;
- the host-RSS handoff decided on all ranks: the flag raised on rank 1
  alone stops both ranks at the same display iteration, rank 0 snapshots
  there, and `--resume` continues from it.

Ranks are spawned with one torch thread each and meet at a `file://`
rendezvous under the run's output directory (`tmp_path`).
"""

import json
import os

import pytest
import torch

from posecnn_torch.cli import train_net
from posecnn_torch.cli.common import load_config
from posecnn_torch.engine import train as ttrain
from posecnn_torch.parallel.mesh import create_mesh, spawn_ranks

torch.set_num_threads(1)
TOY = ["--device", "cpu", "--set", "train.syn_height=48", "train.syn_width=64",
       "train.num_classes=4", "train.fc_dim=32", "train.num_units=8", "train.ims_per_batch=2",
       "train.vertex_reg_2d=True", "train.pose_reg=True", "train.display=1",
       "train.hough_num_samples=64"]


def log_iters(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["iter"] for line in f]


def snapshots(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".npz"))


def test_train_net_num_data_2_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "dp")
    assert train_net.main(["--num_data", "2", "--iters", "2", "--output", out] + TOY) == 0
    assert "--num_data 2: 2 ranks on cpu, cpu" in capsys.readouterr().out
    assert log_iters(out) == [1, 2]
    assert snapshots(out) == ["posecnn_iter_2.npz"]


@pytest.mark.parametrize("num_data,device,cards,want", [
    (-1, "cpu", None, 1), (1, "cpu", None, 1), (5, "cpu", None, 5),
    (-1, "cuda", 1, 1), (-1, "cuda", 4, 4), (2, "cuda", 4, 2)])
def test_num_data_ranks(num_data, device, cards, want):
    assert train_net.num_data_ranks(num_data, device, cards) == want


def test_more_ranks_than_cards_raise_before_any_cuda_call(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"^mesh 3×1 needs 3 devices, have 2$"):
        train_net.main(["--num_data", "3", "--output", str(tmp_path)] + TOY[2:])
    with pytest.raises(ValueError, match="positive count"):
        train_net.num_data_ranks(0, "cpu")


def test_dropout_streams_of_the_data_ranks():
    """Rank 0 keeps the one-process streams; rank d ≥ 1 draws its own."""
    def draws(*rank):
        return [torch.rand(8, generator=g) for g in ttrain.dropout_generators(3, 7, "cpu", *rank)]

    for one, zero in zip(draws(), draws(0)):
        assert torch.equal(one, zero)
    for zero, first, second in zip(draws(0), draws(1), draws(2)):
        assert not torch.equal(zero, first) and not torch.equal(first, second)


def _handoff_rank(rank, device, argv, out):
    """One rank of a run whose host RSS passes the limit on rank 1 only."""
    ttrain.host_rss_gb = lambda: 1e9 if rank == 1 else 0.0
    args = train_net.make_parser().parse_args(argv)
    state = train_net.main_run(args, load_config(args), 4, mesh=create_mesh(2), device=device)
    with open(os.path.join(out, f"rank{rank}.step"), "w") as f:
        f.write(str(state.step))


def test_rss_handoff_on_one_rank_stops_every_rank_and_resumes(tmp_path):
    out = str(tmp_path / "handoff")
    os.makedirs(out)
    argv = ["--output", out] + TOY + ["train.max_host_rss_gb=1.0"]
    spawn_ranks(_handoff_rank, 2, (argv, out), devices=["cpu", "cpu"], backend="gloo",
                rendezvous_dir=out, num_threads=1)
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.step")) as f:
            assert f.read() == "1", rank
    assert log_iters(out) == [1]
    assert snapshots(out) == ["posecnn_iter_1.npz"]
    assert train_net.main(["--num_data", "2", "--resume", "--iters", "3", "--output", out]
                          + TOY) == 0
    assert log_iters(out) == [1, 2, 3]
    assert snapshots(out) == ["posecnn_iter_1.npz", "posecnn_iter_3.npz"]
