"""The port's fault tolerance (`runtime/fault_tolerance.py`,
`runtime/chaos.py`) against the reference's, and the trainer's
`--ckpt-dir` / `--chaos` / `--debug-nans` on the CPU.

- The reference's unit cases (`tests/test_fault_tolerance.py`): straggler
  warmup and MAD flags, rollback determinism, DeviceLoss without a remesh
  is fatal, the survivors handed to the remesh, persistent failure gives
  up, chaos parse / fire-once / debris.
- On one seeded series of step times both `StragglerMonitor`s flag the
  same steps with the same stats; `chaos.parse` refuses the same specs
  with the same messages.
- What the port adds: the ranks' `agree` on the step to restore, a
  remesh that returns None (a rank that is not a survivor: `left_at`),
  `ckpt=None` re-raising.
- The trainer: a run resumed from a checkpoint takes the uninterrupted
  run's steps (losses within 1e-5 relative: the same ops on the same
  values); `--chaos raise@k` rolls back and ends on them; the flags'
  refusals; `--debug-nans` naming the offending layer.
"""
import json
import os

import numpy as np
import pytest

from repro.runtime import chaos as jchaos
from repro.runtime import fault_tolerance as jft
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.launch import train as train_cli
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import (DeviceLoss, ResilientLoop,
                                                 StragglerMonitor)
from repro_torch.train.metrics import MetricsLogger

CLI = ["--arch", "mesh1k", "--smoke", "--batch", "2", "--device", "cpu",
       "--log-every", "1"]


# -------------------------------------------------------------- straggler --

def test_straggler_warmup_suppresses_flags():
    mon = StragglerMonitor(k=5.0, warmup=3)
    assert not mon.record(0, 99.0)
    assert not mon.record(1, 0.1)
    assert not mon.record(2, 0.1)


def test_straggler_mad_flags_and_action():
    hits = []
    mon = StragglerMonitor(k=5.0, warmup=3,
                           action=lambda s, dt: hits.append((s, dt)))
    for i in range(8):
        assert not mon.record(i, 0.1 + 0.001 * (i % 2))
    assert mon.record(8, 2.0)
    assert hits == [(8, 2.0)]
    assert mon.stats["flagged"] == 1
    assert mon.stats["p95"] >= mon.stats["median"]
    assert not mon.record(9, 0.14)


@pytest.mark.parametrize("k,warmup", [(5.0, 3), (3.0, 5), (8.0, 1)])
def test_straggler_flags_the_reference_steps(k, warmup):
    rng = np.random.default_rng(7)
    times = 0.1 + 0.01 * rng.standard_normal(200)
    times[rng.choice(200, 12, replace=False)] *= rng.uniform(1.2, 4.0, 12)
    ours, ref = StragglerMonitor(k, warmup), jft.StragglerMonitor(k, warmup)
    got = [ours.record(s, float(t)) for s, t in enumerate(times)]
    want = [ref.record(s, float(t)) for s, t in enumerate(times)]
    assert got == want and any(got)
    assert ours.flagged == ref.flagged
    assert ours.stats == ref.stats


# --------------------------------------------------------- resilient loop --

def _np_loop(ckdir, **kw):
    """A ResilientLoop over plain-numpy state with a real manager."""
    ck = CheckpointManager(ckdir, keep=3, async_save=False)

    def make_step():
        def run(state, step):
            return {"x": state["x"] * 0.9 + step}, {"loss": state["x"]}
        return run
    return ck, ResilientLoop(ckpt=ck, make_step=make_step, ckpt_every=5,
                             max_failures=2, **kw)


def test_rollback_determinism(tmp_path):
    _, clean = _np_loop(str(tmp_path / "a"))
    ref, step, _ = clean.run({"x": np.float32(1.0)}, 0, 12)
    _, loop = _np_loop(str(tmp_path / "b"))
    state, step, _ = loop.run({"x": np.float32(1.0)}, 0, 12,
                              inject_failure=chaos.raise_at_step(7))
    assert step == 12
    np.testing.assert_array_equal(np.asarray(state["x"]),
                                  np.asarray(ref["x"]))


def test_deviceloss_without_remesh_is_fatal(tmp_path):
    _, loop = _np_loop(str(tmp_path))
    with pytest.raises(DeviceLoss):
        loop.run({"x": np.float32(1.0)}, 0, 12,
                 inject_failure=chaos.drop_device_at_step(
                     3, devices=["d0", "d1", "d2", "d3"]))


def test_deviceloss_hands_survivors_to_remesh(tmp_path):
    seen = []
    _, loop = _np_loop(str(tmp_path))

    def remesh(survivors):
        seen.append(list(survivors))

        def make_step():
            def run(state, step):
                return {"x": state["x"] * 0.9 + step}, {}
            return run
        return make_step, {"x": np.float32(0.0)}
    loop.remesh = remesh
    mpath = str(tmp_path / "m.jsonl")
    loop.metrics = MetricsLogger(mpath, echo=False)
    state, step, _ = loop.run({"x": np.float32(1.0)}, 0, 12,
                              inject_failure=chaos.drop_device_at_step(
                                  7, n_drop=2,
                                  devices=["d0", "d1", "d2", "d3"]))
    loop.metrics.close()
    assert step == 12
    assert seen == [["d0", "d1"]]
    events = [json.loads(ln) for ln in open(mpath)]
    kinds = [e["kind"] for e in events]
    assert "fault" in kinds and "remesh" in kinds and "rollback" in kinds
    assert next(e for e in events if e["kind"] == "remesh")["n_devices"] == 2
    assert next(e for e in events if e["kind"] == "rollback")["step"] == 5


def test_persistent_failure_gives_up(tmp_path):
    _, loop = _np_loop(str(tmp_path))
    with pytest.raises(RuntimeError, match="always"):
        loop.run({"x": np.float32(1.0)}, 0, 12,
                 inject_failure=lambda s: (_ for _ in ()).throw(
                     RuntimeError("always broken")))


def test_a_rank_that_is_not_a_survivor_leaves(tmp_path):
    _, loop = _np_loop(str(tmp_path))
    loop.remesh = lambda survivors: None
    state, step, _ = loop.run({"x": np.float32(1.0)}, 0, 12,
                              inject_failure=chaos.drop_device_at_step(
                                  7, devices=[0, 1, 2]))
    assert step == 7 and loop.left_at == 7


def test_agree_picks_the_step_every_rank_restores(tmp_path):
    """A rank restores the step `agree` returns (rank 0's, broadcast on a
    mesh), not its own view of the directory."""
    ck, loop = _np_loop(str(tmp_path))
    asked = []

    def agree(step):
        asked.append(step)
        return 3                   # an older committed step than this one's
    loop.agree = agree
    loop.ckpt_every = 3
    state, step, _ = loop.run({"x": np.float32(1.0)}, 0, 12,
                              inject_failure=chaos.raise_at_step(7))
    assert asked == [6]
    _, ref = _np_loop(str(tmp_path / "ref"))
    want, _, _ = ref.run({"x": np.float32(1.0)}, 0, 12)
    np.testing.assert_array_equal(np.asarray(state["x"]),
                                  np.asarray(want["x"]))


def test_leaves_and_load_map_the_state(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_save=False)
    box = {"x": np.float32(1.0)}

    def make_step():
        def run(state, step):
            state["x"] = state["x"] * 0.5 + step     # in place
            return state, {}
        return run

    def load(like, tree):
        like["x"] = tree[0]
        return like
    loop = ResilientLoop(ckpt=ck, make_step=make_step, ckpt_every=2,
                         leaves=lambda st: [np.float32(st["x"])], load=load)
    loop.run(box, 0, 6, inject_failure=chaos.raise_at_step(5))
    ref = {"x": np.float32(1.0)}
    for s in range(6):
        ref["x"] = ref["x"] * 0.5 + s
    assert box["x"] == ref["x"]


def test_without_a_manager_a_fault_is_raised():
    loop = ResilientLoop(ckpt=None, make_step=lambda: lambda st, s: (st, {}))
    assert loop.run(1, 0, 3)[1] == 3
    with pytest.raises(RuntimeError, match="injected"):
        loop.run(1, 0, 3, inject_failure=chaos.raise_at_step(1))


# ------------------------------------------------------------------ chaos --

def test_chaos_parse_and_fire_once():
    h = chaos.parse("raise@2")
    h(0)
    h(1)
    with pytest.raises(RuntimeError, match="step 2"):
        h(2)
    h(2)
    k = chaos.parse("kill@1x2", devices=["a", "b", "c"])
    with pytest.raises(DeviceLoss) as ei:
        k(1)
    assert ei.value.survivors == ["a"]
    with pytest.raises(DeviceLoss) as ei:
        chaos.drop_device_at_step(0, devices=[0, 1, 2, 3])(0)
    assert ei.value.survivors == [0, 1, 2]
    with pytest.raises(ValueError, match="cannot drop 1 of 1"):
        chaos.drop_device_at_step(0)(0)       # one process: one rank


@pytest.mark.parametrize("spec,kw", [
    ("raise", {}), ("explode@3", {}), ("corrupt@3", {}), ("kill@x", {}),
    ("raise@2,boom", {}), ("corrupt@z", {"ckpt_dir": "d"})])
def test_chaos_parse_refuses_as_the_reference(spec, kw):
    with pytest.raises(ValueError) as ours:
        chaos.parse(spec, **kw)
    with pytest.raises(ValueError) as ref:
        jchaos.parse(spec, **kw)
    assert str(ours.value) == str(ref.value)


def test_chaos_corrupt_plants_debris(tmp_path):
    d = str(tmp_path)
    h = chaos.parse("corrupt@0,raise@5", ckpt_dir=d)
    h(0)
    assert os.path.isdir(os.path.join(d, "tmp-0"))
    assert os.path.isdir(os.path.join(d, "step-garbage"))
    ck = CheckpointManager(d, async_save=False)
    assert ck.latest_step() is None
    assert not os.path.exists(os.path.join(d, "tmp-0"))
    with pytest.raises(RuntimeError):
        h(5)
    quiet = chaos.parse("corrupt@0", ckpt_dir=str(tmp_path / "q"),
                        plant=False)
    quiet(0)
    assert not os.path.exists(str(tmp_path / "q"))


# ---------------------------------------------------------------- trainer --

def _by_step(res) -> dict:
    return dict(zip(res["steps"], res["losses"]))


def test_resume_and_rollback_take_the_uninterrupted_steps(tmp_path):
    full = train_cli.main(CLI + ["--steps", "4"])
    assert full["steps"] == [0, 1, 2, 3] and full["left_at"] is None
    d = str(tmp_path / "ck")
    first = train_cli.main(CLI + ["--steps", "2", "--ckpt-dir", d,
                                  "--ckpt-every", "2"])
    assert first["checkpoint"]["step"] == 2
    m = CheckpointManager(d, writer=False).read_manifest()
    assert m["extra"] == {"step": 2}
    assert m["plan"]["schema"] == "repro/plan@1"
    assert m["plan"]["mesh"] == {"data": 1, "model": 1}
    resumed = train_cli.main(CLI + ["--steps", "4", "--ckpt-dir", d,
                                    "--ckpt-every", "2"])
    assert resumed["steps"] == [2, 3]
    np.testing.assert_allclose(resumed["losses"], full["losses"][2:],
                               rtol=1e-5)
    mpath = str(tmp_path / "m.jsonl")
    faulted = train_cli.main(CLI + [
        "--steps", "4", "--ckpt-dir", str(tmp_path / "ck2"),
        "--ckpt-every", "2", "--chaos", "corrupt@1,raise@3",
        "--metrics", mpath])
    assert faulted["steps"] == [0, 1, 2, 2, 3]
    np.testing.assert_allclose([_by_step(faulted)[s] for s in range(4)],
                               full["losses"], rtol=1e-5)
    events = [json.loads(ln) for ln in open(mpath)]
    assert [e["step"] for e in events if e["kind"] == "rollback"] == [2]
    assert [e["error"] for e in events if e["kind"] == "fault"] == \
        ["RuntimeError"]
    left = os.listdir(str(tmp_path / "ck2"))
    assert "step-garbage" in left and not [x for x in left
                                           if x.startswith("tmp-")]


def test_lm_checkpoint_resumes_in_the_trainer(tmp_path):
    argv = ["--arch", "hymba-1.5b", "--smoke", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--ckpt-every", "1"]
    full = train_cli.main(argv + ["--steps", "2"])
    d = str(tmp_path)
    train_cli.main(argv + ["--steps", "1", "--ckpt-dir", d])
    resumed = train_cli.main(argv + ["--steps", "2", "--ckpt-dir", d])
    assert resumed["steps"] == [1]
    np.testing.assert_allclose(resumed["losses"], full["losses"][1:],
                               rtol=1e-5)


@pytest.mark.parametrize("extra,match", [
    (["--chaos", "raise@1"], "--ckpt-dir"),
    (["--elastic"], "--ckpt-dir"),
    (["--chaos", "explode@1", "--ckpt-dir", "d"], "unknown chaos kind"),
    (["--ckpt-dir", "d", "--ckpt-every", "0"], "ckpt-every")])
def test_resilience_flags_are_checked(capsys, extra, match):
    with pytest.raises(SystemExit):
        train_cli.parse_args(CLI + extra)
    assert match in capsys.readouterr().err


def test_debug_nans_names_the_layer():
    with pytest.raises(FloatingPointError,
                       match=r"non-finite loss/grad_norm at step \d+; NaN "
                             r"in layer 'conv\d_\d' \['"):
        train_cli.main(CLI + ["--steps", "6", "--lr", "1e30",
                              "--debug-nans"])
