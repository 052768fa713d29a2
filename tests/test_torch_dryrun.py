"""The dry run's cell mode and the sweep (`launch/dryrun.py`,
`launch/sweep.py`, the registry's `ARCHS` / `SHAPES`,
`launch/shardings.py`'s `zero1_tree_specs` / `lm_batch_spec`) against
the reference's.

- The reference's definitions: the registry's lists, shapes,
  `FULL_ATTN_500K` and aliases; `cell_tag` and the sweep's 86 cells;
  `run_one`'s failure JSON (with `subprocess.run` replaced);
  `zero1_tree_specs` and `lm_batch_spec` leaf for leaf at 16 x 16 and
  2 x 16 x 16.
- The reference's builders on 512 host devices, shapes only
  (`tests/jax_mesh_oracles.py dryrun`, no compile): each sharded argument
  of twelve full-size cells (batch, frames, prefix, caches, memory, the
  optimizer state, and every cell's params, held at rest as the
  reference's FSDP blocks) against the port's block on the same rank, by
  per-device shard shape and dtype (the serving cells' params, caches
  and memory bf16; the norms, the SSD's scalars and the router fp32);
  the chip count, the tag and `model_flops_total`, exactly.
- The abstract trace against the same rank's real step on the CPU
  (`tests/torch_dryrun_cases.py`, the fake group of data 2 x model 2,
  SMOKE configs at reduced shapes): FLOPs and the collectives' bytes by
  kind equal, and the kernels' entry points called as often as the path
  derives (the ring's block calls a layer on the rank, the SSD's one).
- One exact count: a one-rank dense prefill's FLOPs are 2 x its matmul
  weights x its tokens plus the plain attention's 4 B H D S^2 a layer.
- The CLI writes the reference's keys (and `rank`, `device`).
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import jax_mesh_oracles as oracles
from repro.configs import registry as jreg
from repro.launch import shardings as jsh
from repro.launch import sweep as jsweep
from repro.models.cnn import meshnet as jmesh
from repro.configs import mesh1k as jmesh1k
from repro.models.lm import transformer as jT
from repro_torch.configs import registry
from repro_torch.core.ring_attention import ring_steps
from repro_torch.launch import dryrun, shardings, sweep
from repro_torch.launch.mesh import PRODUCTION_MESH, Mesh
from repro_torch.models.lm import transformer as tT
from repro_torch.utils import leaves_with_path, tree_leaves, tree_unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod1": PRODUCTION_MESH[False], "pod2": PRODUCTION_MESH[True]}


class _Shape:
    """What the reference's rules read of a mesh: its shape and names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _tuple(spec) -> tuple:
    """A PartitionSpec as the port's tuple, entry for entry."""
    return tuple(spec)


# ------------------------------------------------- the reference's lists --

def test_registry_is_the_references():
    assert registry.ARCHS == jreg.ARCHS
    assert registry.CNN_ARCHS == jreg.CNN_ARCHS
    assert registry.SHAPES == jreg.SHAPES
    assert registry.FULL_ATTN_500K == jreg.FULL_ATTN_500K
    assert registry.SOLVABLE_ARCHS == jreg.SOLVABLE_ARCHS
    names = list(jreg._ALIASES) + jreg.ARCHS + jreg.CNN_ARCHS
    assert [registry.canon(n) for n in names] == \
        [jreg.canon(n) for n in names]
    for arch in registry.ARCHS + registry.CNN_ARCHS:
        assert registry.get(arch).name == jreg.get(arch).name


def test_sweep_cells_and_tags_are_the_references():
    cells = sweep.cells()
    assert len(cells) == 86
    want = [(a, s, mp) for a in jreg.ARCHS for s in jreg.SHAPES
            for mp in (False, True)] + \
        [(a, "cnn", mp) for a in jreg.CNN_ARCHS for mp in (False, True)]
    assert cells == want
    for arch, shape, mp in cells:
        for variant in ("base", "opt", "vpz"):
            assert dryrun.cell_tag(arch, shape, mp, variant) == \
                jsweep.cell_tag(arch, shape, mp, variant)


def test_run_one_failure_json_is_the_references(tmp_path, monkeypatch):
    seen = []

    class _Done:
        returncode = 1
        stderr = "\n".join(f"line {i}" for i in range(20))

    def fake_run(cmd, **kw):
        seen.append((cmd, kw))
        return _Done()
    monkeypatch.setattr(subprocess, "run", fake_run)
    out = {}
    for name, mod in (("port", sweep), ("ref", jsweep)):
        d = tmp_path / name
        assert mod.run_one("olmo_1b", "decode_32k", True, str(d),
                           variant="opt") == {"ok": False}
        out[name] = json.loads((d / "olmo_1b-decode_32k-pod2-opt.json")
                               .read_text())
    assert out["port"] == out["ref"]
    assert out["port"]["error"] == [f"line {i}" for i in range(5, 20)]
    port_cmd, kw = seen[0]
    assert port_cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
    assert port_cmd[port_cmd.index("--device") + 1] == "cuda"
    assert kw["cwd"] == REPO and kw["env"]["PYTHONPATH"] == "src"


def _port_lm_tree(arch, smoke):
    """The port's params of `arch` in the reference's layout, shapes
    only (fake tensors on the CPU)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        cfg = registry.get(arch, smoke=smoke)
        tree = tT.tree_to_jax(tT.init(torch.Generator(), cfg, device="cpu"),
                              cfg)
        return _shapes_of(tree)


def _shapes_of(tree):
    if isinstance(tree, dict):
        return {k: _shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes_of(t) for t in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float32)


@pytest.mark.parametrize("pods", list(MESHES))
@pytest.mark.parametrize("arch,smoke", [("hymba_1_5b", True),
                                        ("olmoe_1b_7b", True),
                                        ("gemma2_9b", False),
                                        ("mixtral_8x7b", False)])
def test_zero1_specs_leaf_for_leaf(arch, smoke, pods):
    ref = jax.eval_shape(lambda k: jT.init(k, jreg.get(arch, smoke=smoke)),
                         jax.random.PRNGKey(0))
    mine = _port_lm_tree(arch, smoke)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    want = [_tuple(s) for s in jax.tree.structure(ref).flatten_up_to(
        jsh.zero1_tree_specs(ref, _Shape(MESHES[pods])))]
    got = [tuple(s) for s in jax.tree.structure(ref).flatten_up_to(
        shardings.zero1_tree_specs(mine, MESHES[pods]))]
    assert got == want
    if not smoke:
        assert any(("data", "model") in s for s in got)


def test_zero1_specs_of_a_cnn_tree():
    key = jax.random.PRNGKey(0)
    ref = jax.eval_shape(lambda k: jmesh.init(k, jmesh1k.CONFIG), key)
    for shape in MESHES.values():
        want = [_tuple(s) for s in jax.tree.structure(ref).flatten_up_to(
            jsh.zero1_tree_specs(ref, _Shape(shape)))]
        got = [tuple(s) for s in jax.tree.structure(ref).flatten_up_to(
            shardings.zero1_tree_specs(ref, shape))]
        assert got == want and any(got)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("pods", list(MESHES))
def test_lm_batch_spec(kind, pods):
    want = {k: _tuple(v) for k, v in
            jsh.lm_batch_spec(_Shape(MESHES[pods]), kind).items()}
    assert shardings.lm_batch_spec(MESHES[pods], kind) == want
    with pytest.raises(ValueError):
        shardings.lm_batch_spec(MESHES[pods], "serve")


# ------------------------------------------------ the subprocess groups --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's builders (512 host devices), the abstract-vs-real
    cells and one CLI cell, in three processes at once."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    procs = {
        "oracle": oracles.popen("dryrun", str(d), devices=512),
        "cells": subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_dryrun_cases.py"), str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "mesh1k", "--shape", "cnn", "--device", "cpu", "--out",
             str(d / "cli")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)}
    outs = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"{name}:\n{err[-4000:]}"
        outs[name] = out
    return {"ref": json.loads((d / "dryrun.json").read_text()),
            "cells": json.loads((d / "cells.json").read_text()),
            "cli": (outs["cli"], json.loads(
                (d / "cli" / "mesh1k-cnn-pod1.json").read_text()))}


# ------------------------------- the argument blocks against the reference --

def _port_cell(arch, shape, pod2, variant):
    """The port's cell on the last rank of the production mesh, shapes
    only: (args, cfg, roles of the params' leaves)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        _, args, cfg = dryrun.build_cell(arch, shape, MESHES[
            "pod2" if pod2 else "pod1"], variant, "cpu")
    return args, cfg


def _moment_paths(params, mu, cfg):
    """{reference keypath of an optimizer moment: this rank's block
    shape} for the port's moments `mu` (flat, params order), stacked
    into the reference's segments."""
    tree = tT.tree_to_jax(tree_unflatten(params, iter(
        [torch.empty(m.shape, device="meta") for m in mu])), cfg) \
        if "layers" in params else tree_unflatten(params, iter(mu))
    return {".mu" + path: tuple(t.shape)
            for path, t in leaves_with_path(tree)}


def _param_paths(params, cfg):
    """{"params" + reference keypath: (this rank's block shape, its
    dtype's name)} of the port's held `params`, an LM's stacked into the
    reference's segments."""
    tree = tT.tree_to_jax(tree_unflatten(params, iter(
        [torch.empty(p.shape, dtype=p.dtype, device="meta")
         for p in tree_leaves(params)])), cfg) \
        if "layers" in params else params
    return {"params" + path: (tuple(t.shape), _dtype(t))
            for path, t in leaves_with_path(tree)}


def _dtype(t) -> str:
    """A tensor's dtype by the reference's (numpy's) name."""
    return str(t.dtype).split(".")[-1]


def _whole(path: str, variant: str, cfg, kind: str = "train") -> bool:
    """Whether the port holds the param at reference keypath `path`
    whole: not a vocabulary block (opt / vpz; a serving cell's only
    where "model" divides the vocabulary) nor an expert block (opt,
    where "model" divides the experts)."""
    if variant != "base" and path in ("['embed']", "['unembed']") and \
            (kind == "train" or cfg.vocab % 16 == 0):
        return False
    ep = variant == "opt" and getattr(cfg, "n_experts", 0) and \
        cfg.n_experts % 16 == 0
    return not (ep and any(path.endswith(f"['moe']['{n}']")
                           for n in shardings.EXPERT_LEAVES))


@pytest.mark.parametrize("cell", oracles.DRYRUN_CELLS,
                         ids=["-".join(map(str, c)) for c in
                              oracles.DRYRUN_CELLS])
def test_argument_blocks_match_the_reference(runs, cell):
    arch, shape, pod2, variant = cell
    ref = runs["ref"][f"{arch}-{shape}-{'pod2' if pod2 else 'pod1'}-"
                      f"{variant}"]
    assert ref["chips"] == math.prod(MESHES["pod2" if pod2 else
                                            "pod1"].values())
    args, cfg = _port_cell(*cell)
    leaves = {k: (tuple(g), tuple(s)) for k, (g, s, _) in
              ref["leaves"].items()}
    dtypes = {k: dt for k, (_, _, dt) in ref["leaves"].items()}
    kind = dryrun.cell_kind(arch, shape)
    checked = 0
    # the params at rest, in every cell: each leaf in the reference's
    # dtype, and each but a vocabulary or expert block (cut within the
    # block) the reference's FSDP block
    mine = _param_paths(args[0], cfg)
    assert set(mine) == {k for k in leaves if k.startswith("params")}
    n_cmp = 0
    for key, (shape_, dt) in mine.items():
        assert dt == dtypes[key], key
        if _whole(key[6:], variant, cfg, kind):
            assert shape_ == leaves[key][1], key
            n_cmp += 1
    assert n_cmp > 0
    checked += n_cmp
    if kind in ("train", "cnn"):
        batch = args[3]
        for name, t in batch.items():
            key = f"[2]['{name}']"
            if key not in leaves:
                continue
            if kind == "cnn" and name == "label":
                # the port cuts the labels as the prediction is cut (the
                # trainer's `shard_batch`), the reference replicates
                # them over "model": the samples agree
                assert t.shape[0] == leaves[key][1][0]
            else:
                assert tuple(t.shape) == leaves[key][1], name
            checked += 1
        # the optimizer state: each whole leaf's block where the
        # reference cuts a dim of the layer (not its stacked count) and
        # the layer's leaf is big enough to be cut on its own
        mine = _moment_paths(args[0], args[1].mu, cfg)
        n_cmp = 0
        for key, (g, s) in leaves.items():
            key = key[3:]                       # "[0]" of args[1:]
            if not key.startswith(".mu") or \
                    not _whole(key[3:], variant, cfg):
                continue
            stacked = "segments" in key
            own = g[1:] if stacked else g
            if math.prod(own) < shardings.MIN_SHARDED or \
                    (stacked and s[0] != g[0]):
                continue
            assert mine[key] == s, key
            n_cmp += 1
        assert n_cmp > 0
        checked += n_cmp
    elif kind == "prefill":
        batch = args[1]
        b_ref = leaves["[0]['tokens']"][1]
        rows = batch["tokens"].shape[1]
        if "patch_embeds" in batch:         # prefix + text, one sequence
            rows += batch["patch_embeds"].shape[1]
            b_ref = (b_ref[0], b_ref[1] + leaves["[0]['patch_embeds']"][1][1])
        assert (batch["tokens"].shape[0], rows) == b_ref
        checked += 1
        for name in ("frames", "patch_embeds"):
            if name in batch:
                assert _dtype(batch[name]) == dtypes[f"[0]['{name}']"]
        if "frames" in batch:
            assert tuple(batch["frames"].shape) == leaves["[0]['frames']"][1]
            checked += 1
    else:
        tokens, caches, length, mem = args[1:]
        assert tuple(tokens.shape) == leaves["[0]"][1]
        assert length == registry.SHAPES[shape]["seq_len"] - 1
        ref_caches = {k: s for k, (g, s) in leaves.items()
                      if k.startswith("[1]")}
        for k, s in ref_caches.items():
            name = k.rsplit("'", 2)[1]
            for entry in caches:
                if name in entry:
                    assert tuple(entry[name].shape) == s[1:], k
                    assert _dtype(entry[name]) == dtypes[k], k
                    checked += 1
        if mem is not None:
            assert tuple(mem.shape) == leaves["[3]"][1]
            assert _dtype(mem) == dtypes["[3]"]
            checked += 1
    assert checked > 0
    tag = dryrun.cell_tag(arch, shape, pod2, variant)
    assert tag == jsweep.cell_tag(arch, shape, pod2, variant)
    if ref["model_flops_total"] is not None:
        assert dryrun.model_flops_total(cfg, shape) == \
            ref["model_flops_total"]


# ----------------------------------------- the trace against the real step --

@pytest.mark.parametrize("name", [c[0] for c in __import__(
    "torch_dryrun_cases").CELLS])
def test_abstract_trace_is_the_real_step(runs, name):
    c = runs["cells"][name]
    fake, real = c["fake"], c["real"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["collectives"] == real["collectives"]
    assert fake["entries"] == real["entries"]
    assert fake["peak_bytes"] >= fake["argument_bytes"] > 0
    # the plain versions ran (the CPU): no kernel's custom op
    assert not any(fake["kernel_calls"].values())


def _ring_calls(types, window, n, idx, s_local):
    """The block calls a forward makes on shard `idx` of `n`: each
    attention layer's ring steps, less the causal blocks from later
    shards."""
    total = 0
    for t in types:
        if t == "ssm":
            continue
        w = window if t in ("swa", "hybrid_s") else None
        causal = t != "enc"
        total += sum(1 for k in range(ring_steps(n, s_local, w))
                     if not (causal and (idx - k) % n > idx))
    return total


@pytest.mark.parametrize("name", ["hymba_train", "hymba_prefill",
                                  "mixtral_opt", "seamless_prefill",
                                  "pixtral_prefill"])
def test_kernel_calls_are_what_the_path_derives(runs, name):
    import torch_dryrun_cases as tc
    c = runs["cells"][name]
    cell = next(x for x in tc.CELLS if x[0] == name)
    shape = cell[2]
    n = tc.MESH["model"]
    idx = c["coords"]["model"]
    cfg = registry.get(c["arch"], smoke=True)
    types = list(c["layer_types"])
    if cfg.is_encdec:
        types = ["enc"] * cfg.n_enc_layers + types
    per_fwd = _ring_calls(types, c["window"], n, idx, shape["seq_len"] // n)
    ssd = sum(t == "ssm" or t.startswith("hybrid") for t in types)
    passes = 2 if shape["kind"] == "train" else 1    # remat's recompute
    want = {"flash_attention_block": passes * per_fwd}
    if ssd:
        want["ssd_chunk"] = passes * ssd
    assert c["fake"]["entries"] == want


def test_one_rank_prefill_flops_are_exact():
    """qwen1.5 SMOKE, one rank, batch 2 x 32: every weight product 2 x
    its params a token, the tied unembedding's too, and the plain
    attention 4 B H D S^2 a layer (the CPU computes every pair)."""
    cfg = registry.get("qwen1_5_0_5b", smoke=True)
    b, s = 2, 32
    r = dryrun.trace_cell("qwen1_5_0_5b",
                          {"seq_len": s, "global_batch": b,
                           "kind": "prefill"},
                          Mesh({"data": 1, "model": 1}, rank=0),
                          device="cpu", cfg=cfg)
    d, hq, hkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim, cfg.d_ff
    per_layer = d * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * f
    want = 2 * b * s * (cfg.n_layers * per_layer + d * cfg.vocab) \
        + cfg.n_layers * 4 * b * hq * hd * s * s
    assert r["flops"] == want
    assert r["collective_bytes"] == 0 and r["collectives"]["count"] == 0


# -------------------------------------------------------------- the CLI --

def test_cli_writes_the_references_keys(runs):
    out, res = runs["cli"]
    assert out.strip().splitlines()[-1].startswith(
        "mesh1k cnn 16x16: OK compute=")
    assert set(res) == {
        "arch", "shape", "variant", "mesh", "chips", "ok", "per_device",
        "roofline_s", "timing", "raw_scan_counted_once", "probe",
        "dominant", "rank", "device", "kernel_calls", "compute_dtype"}
    assert set(res["per_device"]) == {
        "flops", "hbm_bytes", "collective_bytes", "collectives",
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_bytes"}
    assert set(res["per_device"]["collectives"]) == set(
        dryrun.COLLECTIVES) | {"count"}
    pd = res["per_device"]
    assert res["ok"] and res["chips"] == 256 and res["rank"] == 255
    assert res["raw_scan_counted_once"] is None and res["probe"] is None
    assert pd["peak_bytes"] == pd["argument_bytes"] + pd["output_bytes"] \
        + pd["temp_bytes"] - pd["alias_bytes"]
    assert pd["alias_bytes"] > 0         # params and momentum in place
    assert pd["collectives"]["collective-permute"] > 0     # the halos
    assert res["dominant"] == max(res["roofline_s"],
                                  key=res["roofline_s"].get)


def test_cli_refuses_what_it_cannot_run(capsys):
    for bad in ([], ["--arch", "mesh1k", "--shape", "train_4k"],
                ["--arch", "gemma2-9b", "--shape", "cnn"],
                ["--arch", "nope"]):
        with pytest.raises(SystemExit):
            dryrun.main(bad + ["--device", "cpu"])


def test_a_cnn_cell_refuses_the_bf16_variant():
    with pytest.raises(ValueError, match="FP32"):
        dryrun.build_cnn_cell("mesh1k", MESHES["pod1"], variant="opt",
                              device="cpu")
