"""The training launcher's mesh on the CPU: ``--mesh host`` (the default)
trains bit for bit as the step without a mesh; two processes under
``--coordinator`` on the loopback form one gloo group, a (2, 1) mesh,
and end at the same step with equal losses; ``--mesh single`` on one
rank raises ``ValueError``; the launcher leaves no process group
behind."""

import os
import re
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from _torch_mesh import free_port
from _torch_train import one_thread  # noqa: F401
from repro_torch.launch import train
from repro_torch.train import tree as T

pytestmark = pytest.mark.usefixtures("one_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--arch", "hymba-1.5b", "--reduced", "--steps", "3",
         "--ckpt-every", "2", "--microbatches", "2", "--device", "cpu"]


def test_host_mesh_trains_bit_for_bit_as_no_mesh(tmp_path):
    from repro_torch.configs.base import SHAPES, get_config, reduced_shape
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    res = train.main(FLAGS + ["--mesh", "host", "--ckpt",
                              str(tmp_path / "mesh")])
    assert not dist.is_initialized()
    cfg = get_config("hymba-1.5b").reduced()
    model = build_model(cfg)
    batches = train.token_batches(cfg, reduced_shape(SHAPES["train_4k"]),
                                  0, 1, torch.device("cpu"))
    ocfg = AdamWConfig(total_steps=3)
    want = run(make_train_step(model, ocfg, num_microbatches=2),
               make_train_state(model, ocfg, 0, device="cpu"),
               lambda s: batches[s % len(batches)],
               LoopConfig(total_steps=3, ckpt_dir=str(tmp_path / "plain"),
                          ckpt_every=2), logger=lambda s: None)
    assert [m["loss_total"] for m in res.metrics_history] == \
        [m["loss_total"] for m in want.metrics_history]
    for a, b in zip(T.leaves(res.state), T.leaves(want.state)):
        assert torch.equal(a, b)


def test_two_processes_under_a_coordinator(tmp_path):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *FLAGS,
         "--ckpt", str(tmp_path / "ck"), "--coordinator",
         f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    ends = [re.search(r"\[train\] finished at step (\d+); loss (\S+)", o)
            .groups() for o in outs]
    assert ends[0] == ends[1] and ends[0][0] == "3"
    assert "mesh={'data': 2, 'model': 1}" in outs[0]


def test_single_mesh_on_one_rank_raises(tmp_path):
    with pytest.raises(ValueError, match="256"):
        train.main(FLAGS + ["--mesh", "single", "--ckpt", str(tmp_path)])
    assert not dist.is_initialized()
