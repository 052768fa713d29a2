"""The bench workload registry, port of `repro.analysis.workloads`: the
reference's five meshnet configurations and six plan recipes, which its
benchmarks/strategy_exec.py times and which the static lane
(launch/dryrun.py --audit) audits here.

Keeping the registry here means "audit every bench workload's solved plan"
cannot drift from "the plans the bench actually runs": both sides import
the same configs and the same solve recipe.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.cnn import meshnet

CFG128 = meshnet.MeshNetConfig("bench", input_hw=128, in_channels=8,
                               convs_per_block=2, widths=(16, 32, 32),
                               bn_scope="global")
CFG16 = meshnet.MeshNetConfig("bench16", input_hw=16, in_channels=8,
                              convs_per_block=1, widths=(32, 64, 64),
                              bn_scope="global")
CFG2K = meshnet.MeshNetConfig("bench2k", input_hw=64, in_channels=8,
                              convs_per_block=5, widths=(16, 32),
                              bn_scope="global")
CFG16P = meshnet.MeshNetConfig("bench16p", input_hw=32, in_channels=8,
                               convs_per_block=1, widths=(16, 32, 64),
                               bn_scope="global")
CFG2KU = meshnet.MeshNetConfig("bench2ku", input_hw=128, in_channels=8,
                               convs_per_block=2, widths=(16, 32),
                               bn_scope="global")


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    cfg: "meshnet.MeshNetConfig"
    batch: int
    recipe: str          # auto | uniform_h | memfit
    needs_model_axis: bool = False   # skip when the mesh has 1 model way


WORKLOADS = {
    "mesh128": Workload("mesh128", CFG128, 2, "auto"),
    "overlap": Workload("overlap", CFG128, 2, "uniform_h"),
    "mesh16cf": Workload("mesh16cf", CFG16, 2, "auto"),
    "mesh2k_proxy": Workload("mesh2k_proxy", CFG2K, 1, "auto",
                             needs_model_axis=True),
    "mesh16_proxy": Workload("mesh16_proxy", CFG16P, 1, "auto",
                             needs_model_axis=True),
    "mesh2k_unreachable": Workload("mesh2k_unreachable", CFG2KU, 1,
                                   "memfit", needs_model_axis=True),
}


def solve_workload(name: str, machine, mesh, *, table=None,
                   overlap: bool = True, search: str = "greedy"):
    """Solve one bench workload's plan exactly the way the bench does.

    Returns (plan, specs, cfg).  `auto` is the §V-C plan_line solve;
    `uniform_h` is the overlap workload's uniform H-split plan compiled
    through the same cost model; `memfit` derives the synthetic capacity
    limit from the replicated plan's predicted peak (x0.5) and re-solves
    memory-aware — the §VI Table-2 story.  `search` selects the solver's
    search mode (greedy | beam[:N] | hillclimb, strategy.parse_search) for
    the solved recipes; the uniform baseline ignores it.
    """
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import ConvSharding

    w = WORKLOADS[name]
    specs = meshnet.layer_specs(w.cfg, w.batch)
    names = meshnet.layer_names(w.cfg)
    if w.recipe == "uniform_h":
        sh = ConvSharding(batch_axes=("data",), h_axis="model")
        plan = plan_lib.compile_plan(
            {n: plan_lib._sharding_to_dist(sh) for n in names},
            specs, mesh, machine=machine, table=table, overlap=overlap)
    elif w.recipe == "memfit":
        rep = plan_lib.compile_plan(
            {n: plan_lib._sharding_to_dist(ConvSharding()) for n in names},
            specs, mesh, machine=machine, table=table, overlap=overlap)
        limit = 0.5 * rep.predicted["memory"]["peak_bytes"]
        plan = plan_lib.plan_line(machine, specs, mesh, table=table,
                                  overlap=overlap, mem_limit=limit,
                                  search=search)
    else:
        plan = plan_lib.plan_line(machine, specs, mesh, table=table,
                                  overlap=overlap, search=search)
    return plan, specs, w.cfg
