"""Training on a real host mesh (``repro_torch.launch.train --model-parallel M``
over N ranks, `launch.mesh.make_host_mesh`) against the one-device run of
the same argv, on the CPU over gloo.

Each mesh run is N processes (``RANK_PROGRAM``) that meet in a
`torch.distributed.FileStore` under ``tmp_path`` -- no port, so runs of
several test workers at once cannot collide -- and call the launcher's
``main``; rank 0 saves the losses, grad norms and the final params
gathered whole.  The one-device run is the launcher in this process;
`tests/test_torch_train.py` holds that path to the reference's
``loss_fn`` (the reference's own mesh path fails under jax 0.9,
``ROADMAP.md``).

Both runs compute in fp32 (``FP32_PROGRAM``): the launcher's bf16 compute
rounds a sharded matmul's partial sums in another order than the whole
one, and the smoke models' random weights are ill-conditioned enough
(the fan-in quirk, ``ROADMAP.md`` §3) that bf16 grad norms of the two
runs part by up to 20% (measured at ``(1, 2)``), which would hide
anything.  Tolerances, against the largest gaps measured here:

  * each step's loss within ``1e-6`` relative (measured 2.3e-7);
  * each step's grad norm within ``1e-4`` relative (measured 9e-6); a
    run resumed from a mesh's checkpoint, whose params start up to 6e-6
    apart, within ``1e-3`` (measured 3.7e-4: the grad norm is that
    sensitive to the params);
  * every final param within ``1e-4`` absolute, a third of one AdamW
    step at the launcher's lr of 3e-4 (measured 6.4e-6).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh

SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_RTOL, GNORM_RTOL, RESUMED_GNORM_RTOL, PARAM_ATOL = 1e-6, 1e-4, 1e-3, 1e-4
#: seconds a spawned run may take (about 10 s alone at 4 ranks)
RANK_TIMEOUT_S = 240

#: both runs at fp32 compute: the launcher's `Model` with fp32 as its
#: compute dtype default
FP32_PROGRAM = """
import torch
from repro_torch.models import model as _M


class _FP32Model(_M.Model):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("compute_dtype", torch.float32)
        super().__init__(*args, **kwargs)


_M.Model = _FP32Model
"""

RANK_PROGRAM = FP32_PROGRAM + """
import sys
import torch.distributed as dist

store, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
try:
    from repro_torch.launch import train
    res = train.main(sys.argv[5:])
    params = {n: train._whole(p.detach()) for n, p in res["params"].items()}  # every rank
    if rank == 0:
        torch.save(dict(losses=res["losses"], grad_norms=res["grad_norms"],
                        start_step=res["start_step"], params=params), out)
finally:
    dist.destroy_process_group()
"""


@pytest.fixture
def fp32(monkeypatch):
    """The one-device run at fp32 compute, as `FP32_PROGRAM` sets the ranks'."""
    from repro_torch.models import model as M

    base = M.Model

    class FP32Model(base):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("compute_dtype", torch.float32)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(M, "Model", FP32Model)


def smoke(*argv) -> list[str]:
    return ["--device", "cpu", "--preset", "smoke", *argv]


def spawn(tmp_path: Path, world: int, argv, tag: str = "run") -> "tuple[list[int], list[str]]":
    """``argv`` through the launcher on ``world`` ranks; their exit codes
    and outputs (stdout and stderr)."""
    run = tmp_path / tag
    run.mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    logs = [open(run / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK_PROGRAM, str(run / "store"), str(r),
                               str(world), str(run / "out.pt"), *argv],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return rcs, [(run / f"rank{r}.log").read_text() for r in range(world)]


def mesh_run(tmp_path: Path, world: int, argv, tag: str = "run") -> "tuple[dict, str]":
    rcs, logs = spawn(tmp_path, world, argv, tag)
    assert rcs == [0] * world, "\n".join(logs)
    return torch.load(tmp_path / tag / "out.pt"), logs[0]


def same_steps(got, want, loss_rtol=LOSS_RTOL, gnorm_rtol=GNORM_RTOL) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=gnorm_rtol)


def same_params(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for n, w in want.items():
        w = w.detach()
        err = float((got[n] - w).abs().max())
        assert got[n].shape == w.shape and err <= PARAM_ATOL, (n, err)


@pytest.mark.parametrize("arch,world,argv", [
    ("minicpm-2b", 2, ()),                    # (1, 2): the model axis only
    ("minicpm-2b", 4, ()),                    # (2, 2): the batch sharded over data too
    ("minicpm-2b", 4, ("--grad-accum", "2")),  # (2, 2), fp32 sums laid out as the grads
    ("mamba2-780m", 2, ()),                   # (1, 2): the per-shard SSD scan
])
def test_mesh_run_equals_the_one_device_run(arch, world, argv, tmp_path, fp32):
    base = smoke("--arch", arch, "--steps", "3", *argv)
    want = train_cli.main(base)
    metrics = tmp_path / "metrics.json"
    got, log = mesh_run(tmp_path, world, [*base, "--model-parallel", "2",
                                          "--metrics-out", str(metrics)])
    mesh = {"data": world // 2, "model": 2}
    assert f"mesh={mesh}" in log and "training complete" in log
    assert got["start_step"] == 0 and len(got["losses"]) == 3
    same_steps(got, want)
    same_params(got["params"], want["params"])
    written = json.loads(metrics.read_text())  # rank 0's
    assert written["mesh"] == mesh and written["peak_device_bytes"] is None
    assert written["losses"] == got["losses"] and written["grad_norms"] == got["grad_norms"]
    assert written["lrs"] == want["lrs"] and len(written["step_s"]) == 3


def test_mesh_checkpoint_resumes_on_one_device_and_on_the_mesh(tmp_path, fp32):
    """A (1, 2) run of 4 steps writes checkpoints (rank 0, the reference's
    layout, every leaf gathered whole); one device resumes it to 8 steps,
    and so does the mesh (`restore(shardings=)`): both give the straight
    one-device run's losses for steps 4-7 and its final params."""
    ck, ck_mesh = tmp_path / "ck", tmp_path / "ck_mesh"
    straight = train_cli.main(smoke("--steps", "8"))
    _, log = mesh_run(tmp_path, 2, smoke("--steps", "4", "--ckpt-dir", str(ck), "--ckpt-every",
                                         "2", "--model-parallel", "2"), "first")
    assert "training complete" in log
    assert CheckpointManager(str(ck)).steps() == [2, 4]
    shutil.copytree(ck, ck_mesh)
    resume = smoke("--steps", "8", "--ckpt-every", "2", "--resume")
    on_one = train_cli.main([*resume, "--ckpt-dir", str(ck)])
    on_mesh, log = mesh_run(tmp_path, 2, [*resume, "--ckpt-dir", str(ck_mesh),
                                          "--model-parallel", "2"], "resumed")
    assert "resumed from step 4" in log
    tail = dict(losses=straight["losses"][4:], grad_norms=straight["grad_norms"][4:])
    for got in (on_one, on_mesh):
        assert got["start_step"] == 4
        same_steps(got, tail, gnorm_rtol=RESUMED_GNORM_RTOL)
    same_params(on_mesh["params"], straight["params"])
    same_params({n: p.detach() for n, p in on_one["params"].items()}, straight["params"])


def test_model_parallel_without_a_group_is_refused():
    """No process group: the world is this process, so ``--model-parallel
    2`` cannot divide it (the reference's ``data = 0`` mesh fails too)."""
    with pytest.raises(ValueError, match=r"world size 1.*torchrun --nproc-per-node N"):
        train_cli.main(smoke("--model-parallel", "2"))
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        make_host_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="process group of real ranks"):
        make_host_mesh(1, device="cpu")


def test_model_parallel_must_divide_the_world(tmp_path):
    """Two ranks at ``--model-parallel 3``: every rank refuses at the mesh."""
    rcs, logs = spawn(tmp_path, 2, smoke("--steps", "1", "--model-parallel", "3"))
    assert rcs == [1, 1]
    for log in logs:
        assert "ValueError: --model-parallel 3 does not divide the world size 2" in log
