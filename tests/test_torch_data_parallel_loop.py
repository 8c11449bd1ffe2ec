"""The port's training loop at n_data_shards=2 (train/loop.py) on two gloo
ranks on the CPU (parallel/ranks.py, one torch thread a rank, a ``file://``
store under tmp_path), each rank holding one of the batch's two scenes, on
tests/tiny.py's model and scenes, with an eval pass after each epoch.

One launch of the two ranks runs the loop two epochs straight through
('a'), then the same run stopped after epoch 1 and resumed from its
checkpoint ('b'); a second launch runs it straight through again ('c').
Tolerance: exact. The resumed run ends bit-equal to the straight one
(parameters, BatchNorm statistics, Adam's moments), the second launch to
the first, and each rank to the other; rank 0 alone writes the log_dir.
"""

import dataclasses
import json
import os

import pytest
import torch

from graspbalance_tpu_torch.data.synthetic import SceneConfig
from graspbalance_tpu_torch.parallel.ranks import run_ranks
from graspbalance_tpu_torch.train.config import Config, ModelConfig, TrainConfig, config_to_dict
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_ranks import loop_ranks
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

S = 2
LOOP_STEPS = 2
PORT_SCENE = SceneConfig(**{f.name: getattr(TINY_SCENE, f.name) for f in dataclasses.fields(SceneConfig)})
LOOP_CFG = Config(
    model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=TINY_STAGES),
    train=TrainConfig(max_epoch=2, log_every=1, seed=7, n_data_shards=S),
)


def _run(tmp, runs):
    run_ranks(loop_ranks, S, (str(tmp / "in.pt"), str(tmp), runs), init_file=str(tmp / "store"), threads=1,
              timeout=300)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(S)]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """(the directory, per run 'a', 'b', 'c' the ranks' final states)."""
    tmp = tmp_path_factory.mktemp("dp_loop")
    launches = []
    for name, runs in (("first", [("a", None), ("b", 1), ("b", None)]), ("second", [("c", None)])):
        d = tmp / name
        d.mkdir()
        torch.save({"cfg": config_to_dict(LOOP_CFG), "scene": dataclasses.asdict(PORT_SCENE), "steps": LOOP_STEPS},
                   d / "in.pt")
        launches.append(_run(d, [(str(tmp / log_dir), stop) for log_dir, stop in runs]))
    first, second = launches
    return tmp, {"a": [r[0] for r in first], "b": [r[2] for r in first], "c": [r[0] for r in second]}


def _equal_states(x, y):
    assert x["step"] == y["step"]
    assert x["state"].keys() == y["state"].keys()
    for k, v in x["state"].items():
        assert torch.equal(v, y["state"][k]), k
    assert x["optimizer"].keys() == y["optimizer"].keys()
    for i, st in x["optimizer"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], y["optimizer"][i][k]), (i, k)


def test_loop_resumes_bit_equal(loops):
    _, runs = loops
    assert runs["a"][0]["step"] == 2 * LOOP_STEPS
    for r in range(S):
        _equal_states(runs["a"][r], runs["b"][r])


def test_loop_ranks_agree(loops):
    _, runs = loops
    for name in ("a", "b", "c"):
        _equal_states(runs[name][0], runs[name][1])


def test_loop_launches_repeat_bit_equal(loops):
    _, runs = loops
    for r in range(S):
        _equal_states(runs["a"][r], runs["c"][r])


def test_loop_writes_one_set_of_files(loops):
    """Rank 0 alone writes: one config.json, one checkpoint per epoch, one
    metric line per logged step (not one per rank)."""
    tmp, _ = loops
    ckpt = tmp / "a" / "checkpoints"
    assert json.loads((ckpt / "config.json").read_text())["train"]["n_data_shards"] == S
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("step_")) == [f"step_{LOOP_STEPS}.pt",
                                                                          f"step_{2 * LOOP_STEPS}.pt"]
    assert [r["step"] for r in _jsonl(tmp / "a" / "train_metrics.jsonl")] == list(range(1, 2 * LOOP_STEPS + 1))
    assert [r["step"] for r in _jsonl(tmp / "a" / "test_metrics.jsonl")] == [LOOP_STEPS, 2 * LOOP_STEPS]
    # the stopped run logged epoch 1, the resumed one epoch 2 only, into the same streams
    assert [r["step"] for r in _jsonl(tmp / "b" / "train_metrics.jsonl")] == list(range(1, 2 * LOOP_STEPS + 1))
    assert [r["step"] for r in _jsonl(tmp / "b" / "test_metrics.jsonl")] == [LOOP_STEPS, 2 * LOOP_STEPS]
