"""The training launcher's mesh on the CPU: ``--mesh host`` (the default)
trains bit for bit as the step without a mesh, for hymba-1.5b and for
granite-moe-1b-a400m under both ``moe_impl``; two processes under
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


def _meshless_run(arch, steps, microbatches, ckpt_dir):
    """The launcher's run of ``arch`` reduced, by hand with no mesh."""
    from repro_torch.configs.base import SHAPES, get_config, reduced_shape
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    batches = train.token_batches(cfg, reduced_shape(SHAPES["train_4k"]),
                                  0, 1, torch.device("cpu"))
    ocfg = AdamWConfig(total_steps=steps)
    return run(make_train_step(model, ocfg, num_microbatches=microbatches),
               make_train_state(model, ocfg, 0, device="cpu"),
               lambda s: batches[s % len(batches)],
               LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_every=2), logger=lambda s: None)


def _same_run(res, want):
    assert [m["loss_total"] for m in res.metrics_history] == \
        [m["loss_total"] for m in want.metrics_history]
    for a, b in zip(T.leaves(res.state), T.leaves(want.state)):
        assert torch.equal(a, b)


def test_host_mesh_trains_bit_for_bit_as_no_mesh(tmp_path):
    res = train.main(FLAGS + ["--mesh", "host", "--ckpt",
                              str(tmp_path / "mesh")])
    assert not dist.is_initialized()
    _same_run(res, _meshless_run("hymba-1.5b", 3, 2,
                                 str(tmp_path / "plain")))


@pytest.mark.parametrize("impl", ["gather", "ep"])
def test_moe_family_on_the_host_mesh(tmp_path, monkeypatch, impl):
    """``--arch granite-moe-1b-a400m --reduced --mesh host`` takes its 2
    steps, bit for bit the steps without a mesh: the reduced
    capacity_factor 4.0 is above E / k, so neither path drops."""
    from repro_torch.models import flags
    monkeypatch.setattr(flags, "moe_impl", impl)
    res = train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                      "--steps", "2", "--mesh", "host", "--device", "cpu",
                      "--ckpt", str(tmp_path / "mesh")])
    assert not dist.is_initialized()
    assert int(res.state["step"]) == 2 and len(res.metrics_history) == 2
    _same_run(res, _meshless_run("granite-moe-1b-a400m", 2, 1,
                                 str(tmp_path / "plain")))


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
