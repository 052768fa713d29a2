"""Import hygiene of the port: every `repro_torch` module and the chip
smoke script load without jax, networkx and anything of the `repro`
package (the card's machine has neither jax nor networkx)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "networkx"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-c", PROBE, os.path.join(REPO, "src"), REPO],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    expected = {"repro_torch.kernels.conv2d", "repro_torch.kernels.ops",
                "repro_torch.kernels._build", "repro_torch.launch.train",
                "repro_torch.models.cnn.meshnet", "repro_torch.configs.mesh2k",
                "repro_torch.train.metrics", "repro_torch.data.pipeline",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.ssd", "repro_torch.core.ring_attention",
                "repro_torch.core.seq_ssm",
                "repro_torch.models.lm.config",
                "repro_torch.models.lm.modules",
                "repro_torch.models.lm.transformer",
                "repro_torch.models.lm.vocab_parallel",
                "repro_torch.configs.hymba_1_5b",
                "repro_torch.configs.gemma2_9b",
                "repro_torch.configs.qwen2_5_14b",
                "repro_torch.configs.olmo_1b",
                "repro_torch.configs.mamba2_780m",
                "repro_torch.configs.mixtral_8x7b",
                "repro_torch.configs.olmoe_1b_7b",
                "repro_torch.configs.seamless_m4t_large_v2",
                "repro_torch.configs.pixtral_12b",
                "repro_torch.launch.mesh", "repro_torch.core.halo",
                "repro_torch.core.spatial_conv",
                "repro_torch.core.spatial_norm",
                "repro_torch.models.cnn.layers",
                "repro_torch.core.distribution",
                "repro_torch.core.perfmodel", "repro_torch.core.strategy",
                "repro_torch.core.collectives",
                "repro_torch.core.channel_conv", "repro_torch.core.plan",
                "repro_torch.core.dag", "repro_torch.models.cnn.resnet",
                "repro_torch.configs.resnet50",
                "repro_torch.checkpoint.checkpoint",
                "repro_torch.runtime.fault_tolerance",
                "repro_torch.runtime.chaos",
                "repro_torch.analysis", "repro_torch.analysis.lint",
                "repro_torch.analysis.collectives",
                "repro_torch.analysis.workloads",
                "repro_torch.launch.dryrun",
                "repro_torch.launch.shardings",
                "repro_torch.optim.grad_compress"}
    assert expected <= set(out["modules"])


def test_port_sources_name_no_jax():
    """No source line of the port or the smoke script imports jax or the
    reference package."""
    roots = [os.path.join(REPO, "src", "repro_torch")]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root in roots:
        for d, _, fs in os.walk(root):
            files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1].split(".")[0]
                    assert mod not in ("jax", "jaxlib", "repro",
                                       "networkx"), \
                        f"{path}:{i}: {s}"
