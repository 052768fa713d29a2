"""The plan compiler and its reshards (`core/plan.py`,
`core/collectives.py`) on gloo CPU ranks, and the slice as a whole: the
meshnet under solved per-layer plans against the JAX reference with the
same plan on as many host devices (`jax_mesh_oracles.py plan`).

Reshard: on 1 x 2 and 2 x 2, every ordered pair of the layouts N, H, W,
CF and replicated (`torch_dist_cases.RESHARD_KINDS`; on 2 x 2 with
product axes): each rank's block after the reshard equals its block of
the global tensor exactly (it only moves data), the bytes it sent equal
`reshard_bytes`', and in float64 the adjoint identity <R v, u> =
<v, R^T u> holds to 1e-12 relative.

The slice as a whole: mesh1k SMOKE, the reference's CFG16 and CFG128
(`repro/analysis/workloads.py`) and a 19-layer meshnet of mesh1k's depth
and layer names at narrow widths, on 2 and 4 ranks, each under the plan
the reference's `plan_line(LASSEN, ...)` solves (the 19-layer net under
full-width mesh1k's plans at batch 1 and 2, lowered by
`plan_from_spec`: H -> CF -> H, N -> CF -> N, and H -> CF -> replicated
with a demotion at 4 ranks); and mesh1k SMOKE under the uniform plan on
8 ranks, where its stride-2 layer at 16 rows drops `model` (2 rows a
shard) and takes a reshard, and its BN, fitted to the 8-row output as the
reference fits it, a second one.  Loss and every param's gradient within
1e-5 of the reference's, relative to the largest magnitude of each (f32
sums in other orders); for the 19-layer net, whose BN over the last
blocks' few pixels amplifies rounding, where the reference's and the
port's one-device runs in f32 already differ by more, within 4 times
the largest such difference over its leaves (the f32 floor of this
function, 3.0e-5 to 7.2e-5 on the four cases), and that floor itself
held under DEEP_FLOOR_MAX = 1e-4, so that a fault in the port's
one-device path fails rather than widening the tolerance.

The reference is its run with the same plan on as many host devices,
except for a plan whose every BN normalises as one device does (no
local-scope statistics of a split batch or image): its function is the
one-device meshnet's, and it is held against the reference's one-device
run.  The reference's own gradients under such plans are not: where
GSPMD partitions its sample-parallel layers (no shard_map), they differ
from its one-device and float64 gradients by up to about 1e-2 relative
at CFG128's size on jax 0.9.0, while its loss agrees (ROADMAP Queue 3).

The trainer under the uniform plan on 8 ranks trains with equal losses
and params.
"""
import json

import jax
import numpy as np
import pytest

import jax_mesh_oracles
import torch_dist_cases as cases
from repro.analysis import workloads
from repro.configs import mesh1k as jmesh1k
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.models.cnn import meshnet as jmesh
from repro_torch.core import collectives
from repro_torch.core import plan as tplan
from repro_torch.models.cnn import meshnet as tmesh


@pytest.fixture(scope="module", autouse=True)
def _reference_eta_unmeasured():
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield


# a meshnet of mesh1k's depth and layer names at narrow widths
DEEP = jmesh.MeshNetConfig("deep19", input_hw=128, in_channels=4,
                           convs_per_block=3, widths=(8, 8, 16, 16, 16, 16))
# (case, config, batch, mesh dims, the config whose solve gives the plan:
# None for the uniform plan)
PLAN_CASES = [
    ("smoke_b1_1x2", jmesh1k.SMOKE, 1, (1, 2), jmesh1k.SMOKE),
    ("smoke_b2_2x2", jmesh1k.SMOKE, 2, (2, 2), jmesh1k.SMOKE),
    ("cfg16_b1_1x2", workloads.CFG16, 1, (1, 2), workloads.CFG16),
    ("cfg16_b1_2x2", workloads.CFG16, 1, (2, 2), workloads.CFG16),
    ("cfg16_b2_1x4", workloads.CFG16, 2, (1, 4), workloads.CFG16),
    ("cfg128_b1_2x2", workloads.CFG128, 1, (2, 2), workloads.CFG128),
    ("cfg128_b2_1x2", workloads.CFG128, 2, (1, 2), workloads.CFG128),
    ("mesh1k_b1_1x2", DEEP, 1, (1, 2), jmesh.MESH1K),
    ("mesh1k_b2_1x2", DEEP, 2, (1, 2), jmesh.MESH1K),
    ("mesh1k_b2_2x2", DEEP, 2, (2, 2), jmesh.MESH1K),
    ("mesh1k_b2_1x4", DEEP, 2, (1, 4), jmesh.MESH1K),
    ("uniform_b2_1x8", jmesh1k.SMOKE, 2, (1, 8), None),
]
MESHES = sorted({c[3] for c in PLAN_CASES})
RTOL = 1e-5
# the most the port's and the reference's one-device runs of DEEP may
# differ (relative, over its loss and leaves); 3.0e-5 to 7.2e-5 measured
DEEP_FLOOR_MAX = 1e-4


def _mesh_shape(dims):
    return {"data": dims[0], "model": dims[1]}


def _spec(case):
    _, cfg, batch, dims, solve_cfg = case
    if solve_cfg is None:
        return None
    plan = jplan.plan_line(jpm.LASSEN, jmesh.layer_specs(solve_cfg, batch),
                           _mesh_shape(dims))
    return plan.to_spec(_mesh_shape(dims))


@pytest.fixture(scope="module")
def plan_runs(tmp_path_factory):
    """The JAX oracle (in two processes) and the gloo ranks of every mesh,
    all at once."""
    d = tmp_path_factory.mktemp("plan")
    recs, flat = [], {}
    for i, case in enumerate(PLAN_CASES):
        name, cfg = case[0], case[1]
        rec = {"name": name, "batch": case[2], "dims": list(case[3]),
               "spec": _spec(case),
               "cfg": {k: getattr(cfg, k) for k in (
                   "name", "input_hw", "in_channels", "convs_per_block",
                   "widths", "n_classes", "bn_scope")}}
        # the reference's one-device run: the oracle of a plan whose BN
        # all normalise like one device, the f32 floor of DEEP
        rec["one_device"] = cfg is DEEP or _one_device_bn(
            _port_plan(rec, cfg, case[2], case[3]), cfg.bn_scope)
        recs.append(rec)
        params = jmesh.init(jax.random.PRNGKey(i), cfg)
        flat.update({f"{name}/{li}.{k}.{pk}": np.asarray(v)
                     for li, layer in enumerate(params)
                     for k, sub in layer.items() for pk, v in sub.items()})
    (d / "plans.json").write_text(json.dumps(recs))
    np.savez(d / "inputs.npz", **flat)
    procs = {}
    for dims in MESHES:
        sub = d / f"r{dims[0]}x{dims[1]}"
        sub.mkdir()
        for f in ("plans.json", "inputs.npz"):
            (sub / f).write_bytes((d / f).read_bytes())
        procs[dims] = (sub, cases.start("plan", dims, str(sub)))
    oracles = [jax_mesh_oracles.popen("plan", str(d), f"{k}/2")
               for k in range(2)]
    want = {}
    for k, p in enumerate(oracles):
        jax_mesh_oracles.wait(p)
        want.update(np.load(d / f"plan{k}.npz"))
    got = {dims: cases.collect(p, dims, str(sub))
           for dims, (sub, p) in procs.items()}
    return want, got, {r["name"]: r for r in recs}, d


def _port_plan(rec, cfg, batch, dims):
    tcfg = tmesh.MeshNetConfig(**{**rec["cfg"], "widths": tuple(cfg.widths)})
    if rec["spec"] is None:
        from repro_torch.core.spatial_conv import ConvSharding
        return tmesh.network_plan(tcfg, ConvSharding(
            batch_axes=("data",), h_axis="model"), _mesh_shape(dims))
    return tplan.plan_from_spec(rec["spec"], tmesh.layer_specs(tcfg, batch),
                                _mesh_shape(dims))


def _one_device_bn(plan, scope: str) -> bool:
    """Whether every BN of `plan` takes the statistics one device would:
    of the whole batch and image."""
    for lp in list(plan.layers.values())[:-1]:      # pred has no BN
        sh = lp.out_sharding
        batch, spatial = bool(sh.batch_axes), sh.is_spatial
        if getattr(sh, "cf_axis", None) is not None:
            ok = scope == "global" or not batch and (
                scope == "spatial" or not spatial)
        else:
            ok = not spatial or scope == "global" or (
                scope == "spatial" and not batch)
        if not ok:
            return False
    return True


def _port_one_device(rec, cfg, batch, d) -> tuple[float, list]:
    """The port's one-device loss and gradients of a case (CPU)."""
    import torch
    from repro_torch.data import pipeline
    from repro_torch.utils import tree_leaves
    tcfg = tmesh.MeshNetConfig(**{**rec["cfg"], "widths": tuple(cfg.widths)})
    model = tmesh.MeshNet(tcfg, generator=torch.Generator(), device="cpu")
    flat = np.load(d / "inputs.npz")
    model.params_from_jax([
        {k: {pk: flat[f"{rec['name']}/{i}.{k}.{pk}"] for pk in sub}
         for k, sub in layer.items()}
        for i, layer in enumerate(model.params())])
    b = pipeline.to_device(pipeline.synthetic_mesh_batch(
        0, batch, tcfg.input_hw, tcfg.in_channels, out_hw=tcfg.out_hw),
        torch.device("cpu"))
    params = model.params()
    loss = tmesh.loss_fn(params, b, tcfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_loss_and_grads_match_the_reference(plan_runs, case):
    want, got, recs, d = plan_runs
    name, cfg, batch, dims, solve_cfg = case
    outs = got[dims]
    plan = _port_plan(recs[name], cfg, batch, dims)
    ref = f"{name}/one" if _one_device_bn(plan, cfg.bn_scope) else name
    n_leaves = sum(k.startswith(f"{ref}/grad") for k in want)
    assert n_leaves == 3 * (len(jmesh.layer_names(cfg)) - 1) + 1
    for o in outs:                    # one loss and grad on every rank
        np.testing.assert_array_equal(o[f"{name}/loss"],
                                      outs[0][f"{name}/loss"])
        for i in range(n_leaves):
            np.testing.assert_array_equal(o[f"{name}/grad{i}"],
                                          outs[0][f"{name}/grad{i}"])
    loss, want_loss = float(outs[0][f"{name}/loss"]), \
        float(want[f"{ref}/loss"])
    tol = RTOL
    if cfg is DEEP:
        one_loss, one_grads = _port_one_device(recs[name], cfg, batch, d)
        floor = [abs(one_loss - float(want[f"{name}/one/loss"]))
                 / abs(one_loss)] + [
            np.abs(a - want[f"{name}/one/grad{i}"]).max()
            / np.abs(want[f"{name}/one/grad{i}"]).max()
            for i, a in enumerate(one_grads)]
        assert max(floor) <= DEEP_FLOOR_MAX, \
            f"one-device runs differ by {max(floor):.3e} (ceiling " \
            f"{DEEP_FLOOR_MAX})"
        tol = max(RTOL, 4 * max(floor))
    assert np.isfinite(loss) and \
        abs(loss - want_loss) <= tol * abs(want_loss), (loss, want_loss)
    for i in range(n_leaves):
        g, r = outs[0][f"{name}/grad{i}"], want[f"{ref}/grad{i}"]
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= tol, f"leaf {i}: {err:.3e} against {ref} (tol {tol})"
    assert int(outs[0][f"{name}/n_reshards"]) == plan.n_reshards
    # the plan the ranks ran is the reference's: the same reshard points
    if solve_cfg is not None:
        jp = jplan.plan_from_spec(recs[name]["spec"],
                                  jmesh.layer_specs(cfg, batch),
                                  _mesh_shape(dims))
        assert plan.n_reshards == jp.n_reshards
        assert plan.describe() == jp.describe()


def test_the_cases_cover_cf_reshards_and_demotions(plan_runs):
    """CF layers, reshard points, a CF x spatial layer, a replicated
    layer and a geometry demotion all occur among the solved plans, and
    the full-width plans have the N -> CF -> N and H -> CF -> H shapes."""
    _, got, recs, _ = plan_runs
    seen = set()
    for name, cfg, batch, dims, solve_cfg in PLAN_CASES:
        if solve_cfg is None:
            continue
        p = _port_plan(recs[name], cfg, batch, dims)
        for lp in p.layers.values():
            sh = lp.sharding
            cf = getattr(sh, "cf_axis", None) is not None
            seen |= {"cf"} if cf else set()
            seen |= {"cf_spatial"} if cf and sh.is_spatial else set()
            seen |= {"reshard"} if lp.reshard_in else set()
            seen |= {"demoted"} if "demoted" in lp.note else set()
            seen |= {"replicated"} if not any(
                collectives.layout(sh)) else set()
        if name.startswith("mesh1k"):
            kinds = [("CF" if getattr(lp.sharding, "cf_axis", None) else
                      "N" if lp.sharding.batch_axes else
                      "H" if lp.sharding.h_axis else "R")
                     for lp in p.layers.values()]
            runs = [k for i, k in enumerate(kinds) if not i
                    or k != kinds[i - 1]]
            assert runs in (["N", "CF", "N"], ["H", "CF", "H"],
                            ["H", "CF", "R"]), (name, kinds)
    assert seen == {"cf", "cf_spatial", "reshard", "demoted",
                    "replicated"}, seen
    uni = got[(1, 8)][0]["uniform_b2_1x8/n_reshards"]
    assert int(uni) == 2          # conv3_1 drops `model`, its BN keeps it


@pytest.fixture(scope="module")
def reshard_runs(tmp_path_factory):
    procs = {}
    for dims in RESHARD_MESHES:
        d = str(tmp_path_factory.mktemp("rs"))
        procs[dims] = (d, cases.start("reshard", dims, d))
    return {dims: cases.collect(p, dims, d)
            for dims, (d, p) in procs.items()}


RESHARD_MESHES = [(1, 2), (2, 2)]
PAIRS = [(dims, a, b) for dims in RESHARD_MESHES
         for a in cases.RESHARD_KINDS[dims] for b in cases.RESHARD_KINDS[dims]]


@pytest.mark.parametrize("dims,src,dst", PAIRS,
                         ids=[f"{d[0]}x{d[1]}-{a}-{b}" for d, a, b in PAIRS])
def test_reshard_moves_blocks_and_is_its_adjoints_transpose(reshard_runs,
                                                            dims, src, dst):
    outs = reshard_runs[dims]
    x = cases.reshard_input()
    lay = cases.RESHARD_KINDS[dims][dst]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[f"{src}_{dst}/y"],
                                      cases.block(x, r, dims, *lay))
        assert int(o[f"{src}_{dst}/sent"]) == \
            int(o[f"{src}_{dst}/want_sent"])
    lhs, rhs = outs[0][f"{src}_{dst}/adjoint"]
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs), (lhs, rhs)
    if src == dst:
        assert int(outs[0][f"{src}_{dst}/sent"]) == 0


def test_reshard_steps_fuse_a_moving_axis_into_one_all_to_all():
    steps = collectives.reshard_steps(((), ("model",), (), ()),
                                      (("model",), (), (), ()))
    assert steps == [("all_to_all", "model", 1, 0)]
    steps = collectives.reshard_steps((("data",), ("model",), (), ()),
                                      ((), (), (), ()))
    assert sorted(s[0] for s in steps) == ["gather", "gather"]
    steps = collectives.reshard_steps(((), (), (), ()),
                                      (("data", "model"), (), (), ()))
    assert steps == [("slice", "data", 0), ("slice", "model", 0)]


def test_uniform_trains_on_eight_ranks_with_a_reshard(tmp_path):
    """mesh1k SMOKE at --model 8 under --strategy uniform: conv3_1 drops
    `model` and takes a reshard (its BN a second); every rank exits 0
    with the same finite losses and params."""
    import test_torch_train_dist as td
    args = ["--arch", "mesh1k", "--smoke", "--model", "8", "--steps", "2",
            "--device", "cpu", "--batch", "2", "--strategy", "uniform"]
    res, outs = td._launch(tmp_path, 8, args)
    assert all(r == res[0] for r in res)
    assert all(np.isfinite(res[0]["losses"]))
    assert "2 reshard points" in outs[0] and "shuffle <- " in outs[0]
