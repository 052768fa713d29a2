"""The trainer on a mesh of CPU ranks (`launch/train.py` over gloo).

Two processes started as torchrun starts them (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a free port), and once through
torchrun itself, train the smoke mesh1k under the uniform plan with
`--model 2`: both exit 0 with the same losses and the same params, and
only rank 0 prints.  Four ranks at pod 2 x model 2 train exactly as at
data 2 x model 2.  The mesh flags' refusals are checked in process, and
the uniform plan's reshard points where a layer's geometry drops the
spatial axis (once refused, before there were reshards).
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.plan import NetworkPlan
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh
from repro_torch.models.cnn import meshnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "mesh1k", "--smoke", "--model", "2", "--steps", "2",
        "--device", "cpu", "--batch", "4"]
RANK_MAIN = r"""
import json, sys
from repro_torch.launch import train
from repro_torch.utils import tree_leaves
r = train.main(sys.argv[1:])
print("RESULT " + json.dumps({
    "losses": r["losses"],
    "digest": [float(p.detach().double().sum()) for p in
               tree_leaves(r["params"])]}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("WORLD_SIZE", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, n: int, args: list) -> tuple[list, list]:
    """Start `n` ranks as torchrun does; (each rank's RESULT, its stdout)."""
    port, procs = _free_port(), []
    for rank in range(n):
        env = _env()
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, *args], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    res = [json.loads(next(l for l in o.splitlines()
                           if l.startswith("RESULT "))[7:]) for o in outs]
    return res, outs


def test_two_ranks_train_with_equal_losses_and_params(tmp_path):
    res, outs = _launch(tmp_path, 2, ARGS)
    assert len(res[0]["losses"]) == 2
    assert res[0] == res[1]
    assert "done at step 2" in outs[0] and "done at step 2" not in outs[1]
    assert "mesh={'data': 1, 'model': 2}" in outs[0]


def test_pod_axis_shards_the_batch_like_data(tmp_path):
    """pod 2 x model 2 lays ranks out as data 2 x model 2 and splits N
    over (pod, data) as over data: the same losses and params, on all
    four ranks."""
    base = ARGS[:ARGS.index("--model")] + ARGS[ARGS.index("--steps"):]
    pod, outs = _launch(tmp_path, 4, base + ["--model", "2", "--pod", "2"])
    data, _ = _launch(tmp_path, 4, base + ["--model", "2", "--data", "2"])
    assert "mesh={'pod': 2, 'data': 1, 'model': 2}" in outs[0]
    assert all(r == pod[0] for r in pod + data)


def test_torchrun_trains_on_two_ranks(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGS,
         "--metrics", str(tmp_path / "m.jsonl")],
        capture_output=True, text=True, timeout=240, env=_env(),
        cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("done at step 2; final loss") == 1
    recs = [json.loads(l) for l in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [x["kind"] for x in recs] == ["run", "step", "step", "done"]
    assert recs[0]["mesh"] == {"data": 1, "model": 2}


def test_mesh_flags_are_checked():
    with pytest.raises(SystemExit, match="2 processes|1 processes"):
        train.setup(train.parse_args(ARGS))
    with pytest.raises(SystemExit):
        train.parse_args(ARGS[:-2] + ["--batch", "3", "--data", "2"])
    with pytest.raises(SystemExit):
        train.parse_args(ARGS + ["--strategy", "auto", "--search", "dfs"])


@pytest.mark.parametrize("arch,smoke,model,fits", [
    ("mesh1k", True, 2, True), ("mesh1k", True, 8, False),
    ("mesh1k", False, 4, True), ("mesh1k", False, 8, False),
    ("mesh2k", False, 8, True)])
def test_check_fits_refuses_layers_that_need_a_reshard(arch, smoke, model,
                                                       fits):
    """The meshes that were refused before there were reshards: the
    uniform plan, fitted to every layer, has reshard points exactly
    there, and each one's layer is demoted (§III-A)."""
    cfg = registry.get(arch, smoke=smoke)
    mesh = Mesh({"data": 1, "model": model}, rank=0)
    sh = ConvSharding(batch_axes=("data",), h_axis="model")
    plan = NetworkPlan.uniform(sh, specs=meshnet.layer_specs(cfg, 1),
                               mesh=mesh)
    assert (plan.n_reshards == 0) == fits
    for lp in plan.layers.values():
        assert lp.reshard_in == ("demoted h_axis" in lp.note)


def test_one_process_keeps_the_one_device_plan():
    args = train.parse_args(["--arch", "mesh1k", "--smoke", "--device",
                             "cpu"])
    device, mesh, rank = train.setup(args)
    assert mesh is None and rank == 0 and device == torch.device("cpu")
    plan = train.build(args, device, mesh)[-1]
    assert plan.n_reshards == 0
    assert all(plan.sharding(n) == ConvSharding()
               for n in meshnet.layer_names(registry.get("mesh1k", True)))
