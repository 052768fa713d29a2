"""The port's ResNet (`models/cnn/resnet.py`) on one device (CPU, the
conv's plain version) against the JAX reference's, params carried across
by `ResNet.params_from_jax`.

- The tiny config (`input_hw=32, stages=(1, 1), widths=(8, 16)`) and the
  reference's SMOKE config at batch 2 on `synthetic_imagenet_batch`: the
  loss within 3e-5 relative of the reference's and every gradient within
  rtol 5e-4 / atol 5e-5 of it (the reference's own
  `tests/dist_checks.py` tolerances for the tiny config).  SMOKE's last
  stage runs at 1x1 pixels, so each of its BNs normalises 2 values: its
  output is +-1 whatever the input, the gradient through it is zero in
  exact arithmetic, and what comes out is rounding, amplified.  There the
  reference's own f32 gradients are up to 1.5e-2 from its float64 ones,
  so SMOKE's gradients are held against the reference in float64 (under
  `jax.enable_x64`), leaf by leaf: each leaf's largest difference, over
  the leaf's largest magnitude, within rtol 5e-4 or 4 times the same
  measure of the reference's own f32 gradient of that leaf, whichever is
  larger (as `test_torch_plan.py` holds its 19-layer net), and each
  leaf's f32 floor held under SMOKE_FLOOR_MAX, so that a fault in the
  port fails rather than widening the tolerance.
- `synthetic_imagenet_batch` is bit-identical to the reference's.
- Max pooling at ties: the reference pools with `jnp.max` over stacked
  shifted slices (not `reduce_window`), whose gradient splits evenly
  among equal maxima, as the port's `amax` does: the two give the same
  gradient at ties, and after a ReLU a window of zeros sends nothing back
  through either (tied zeros come from negative inputs).
- The param tree and count (25,557,032 at full width), the registry, the
  trainer's entry point on the CPU and its refusal of a missing card,
  and `shard_batch` of class labels.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet50 as jcfgs
from repro.data import pipeline as jpipe
from repro.models.cnn import layers as jlayers
from repro.models.cnn import resnet as jres
from repro.core.spatial_conv import ConvSharding as JConvSharding
from repro_torch.configs import registry as treg
from repro_torch.configs import resnet50 as tcfgs
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh
from repro_torch.models.cnn import layers as tlayers
from repro_torch.models.cnn import resnet as tres
from repro_torch.utils import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"name": "tiny", "input_hw": 32, "n_classes": 10, "stages": (1, 1),
        "widths": (8, 16)}
CONFIGS = {"tiny": (jres.ResNetConfig(**TINY), tres.ResNetConfig(**TINY)),
           "smoke": (jcfgs.SMOKE, tcfgs.SMOKE)}
LOSS_RTOL, RTOL, ATOL = 3e-5, 5e-4, 5e-5
# the most SMOKE's reference f32 gradient of a leaf may be from its float64
# one, relative to the leaf's largest magnitude (at most 1.5e-2 measured on
# jax 0.9.0, in res5's 2a; 2.4e-6 to 4.6e-3 elsewhere)
SMOKE_FLOOR_MAX = 5e-2


def _port_model(tcfg, jparams):
    m = tres.ResNet(tcfg, generator=torch.Generator(), device="cpu")
    return m.params_from_jax(jax.tree.map(np.asarray, jparams))


def _reference(jcfg, params, batch, x64=False):
    if not x64:
        l, g = jax.jit(jax.value_and_grad(
            lambda p: jres.loss_fn(p, batch, jcfg)))(params)
        return float(l), [np.asarray(a) for a in jax.tree.leaves(g)]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           params)
        b64 = {"image": jnp.asarray(batch["image"], jnp.float64),
               "label": jnp.asarray(batch["label"])}
        l, g = jax.jit(jax.value_and_grad(
            lambda p: jres.loss_fn(p, b64, jcfg)))(p64)
        return float(l), [np.asarray(a) for a in jax.tree.leaves(g)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_the_reference(name):
    jcfg, tcfg = CONFIGS[name]
    params = jres.init(jax.random.PRNGKey(0), jcfg)
    batch = jpipe.synthetic_imagenet_batch(0, 2, jcfg.input_hw,
                                           jcfg.n_classes)
    want_loss, want = _reference(jcfg, params, batch)
    model = _port_model(tcfg, params)
    p = model.params()
    tb = tpipe.to_device(tpipe.synthetic_imagenet_batch(
        0, 2, tcfg.input_hw, tcfg.n_classes), torch.device("cpu"))
    loss = tres.loss_fn(p, tb, tcfg)
    got = [g.numpy() for g in torch.autograd.grad(loss, tree_leaves(p))]
    loss = loss.detach()
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert len(got) == len(want)
    if name == "tiny":
        for i, (a, r) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL,
                                       err_msg=f"leaf {i}")
        return
    _, exact = _reference(jcfg, params, batch, x64=True)
    for i, (a, r, e) in enumerate(zip(got, want, exact)):
        scale = np.abs(e).max()
        floor = np.abs(r - e).max() / scale
        assert floor <= SMOKE_FLOOR_MAX, (i, floor)
        err = np.abs(a - e).max() / scale
        assert err <= max(RTOL, 4 * floor), (i, err, floor)


def test_synthetic_imagenet_batch_is_bit_identical():
    for step, n, hw, k in ((0, 2, 32, 10), (5, 3, 224, 1000)):
        a = jpipe.synthetic_imagenet_batch(step, n, hw, k)
        b = tpipe.synthetic_imagenet_batch(step, n, hw, k)
        for key in ("image", "label"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _pool_grads(x, g):
    """dx of sum(max_pool(relu(x)) * g) in both packages (3x3/2 SAME)."""
    xt = torch.from_numpy(x).requires_grad_()
    y = tlayers.max_pool(torch.relu(xt), sharding=ConvSharding())
    (y * torch.from_numpy(g)).sum().backward()

    def f(z):
        return (jlayers.max_pool(jnp.maximum(z, 0.0),
                                 sharding=JConvSharding()) * g).sum()
    return xt.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x))), \
        y.detach().numpy()


def test_max_pool_gradient_at_ties():
    g = np.ones((1, 2, 2, 1), np.float32)
    # one window of four equal positive maxima
    x = np.zeros((1, 4, 4, 1), np.float32) - 1.0
    x[0, 0:2, 0:2, 0] = 3.0
    port, ref, y = _pool_grads(x, g)
    assert y[0, 0, 0, 0] == 3.0
    # both split the window's gradient evenly among the tied maxima
    np.testing.assert_array_equal(port[0, 0:2, 0:2, 0], 0.25)
    np.testing.assert_array_equal(port, ref)
    # the other windows see only ReLU zeros of negative inputs: nothing
    # goes back through the ReLU in either package
    for a in (port, ref):
        mask = np.ones_like(a, bool)
        mask[0, 0:2, 0:2, 0] = False
        assert not a[mask].any()
    # without ties (a continuous random input) the two agree
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)) \
        .astype(np.float32)
    g = np.random.default_rng(1).standard_normal((2, 4, 4, 3)) \
        .astype(np.float32)
    port, ref, _ = _pool_grads(x, g)
    np.testing.assert_array_equal(port, ref)


def test_param_tree_count_and_loading():
    m = tres.ResNet(tres.RESNET50, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    leaves = tree_leaves(m.params())
    assert sum(p.numel() for p in leaves) == 25_557_032
    assert len(leaves) == 1 + 2 + 16 * 9 + 4 * 3 + 2
    blocks = m.params()["blocks"]
    assert [("proj" in b) for b in blocks] == \
        [i in (0, 3, 7, 13) for i in range(16)]
    small = tres.ResNet(tcfgs.SMOKE, generator=torch.Generator(),
                        device="cpu")
    tree = jax.tree.map(np.asarray,
                        jres.init(jax.random.PRNGKey(3), jcfgs.SMOKE))
    small.params_from_jax(tree)
    np.testing.assert_array_equal(small.params()["blocks"][1]["proj"]["w"]
                                  .detach().numpy(),
                                  tree["blocks"][1]["proj"]["w"])
    bad = dict(tree, head={"w": tree["head"]["w"][:, :3],
                           "b": tree["head"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        small.params_from_jax(bad)
    with pytest.raises(ValueError, match="entries"):
        small.params_from_jax(dict(tree, blocks=tree["blocks"][:-1]))
    with pytest.raises(ValueError, match="keys"):
        small.params_from_jax({k: v for k, v in tree.items() if k != "bn1"})
    assert treg.get("resnet50") is tres.RESNET50
    assert treg.get("resnet50", smoke=True) is tcfgs.SMOKE


def test_shard_batch_cuts_class_labels_along_the_head_batch_axes():
    b = tpipe.synthetic_imagenet_batch(0, 4, 8, 10)
    mesh = Mesh({"data": 2, "model": 2}, rank=3)
    from repro_torch.core.channel_conv import CFSharding
    out = tpipe.shard_batch(b, mesh, ConvSharding(h_axis="model"),
                            CFSharding(batch_axes=("data",),
                                       cf_axis="model"))
    np.testing.assert_array_equal(out["image"], b["image"][:, 4:])
    np.testing.assert_array_equal(out["label"], b["label"][2:])
    out = tpipe.shard_batch(b, mesh, ConvSharding(batch_axes=("data",
                                                              "model")))
    np.testing.assert_array_equal(out["label"], b["label"][3:])


def test_trainer_trains_smoke_on_the_cpu(tmp_path):
    r = train_cli.main(["--arch", "resnet50", "--smoke", "--steps", "2",
                        "--batch", "4", "--device", "cpu",
                        "--metrics", str(tmp_path / "m.jsonl")])
    assert len(r["losses"]) == 2 and all(map(math.isfinite, r["losses"]))
    assert r["n_params"] == 28362
    recs = [json.loads(l) for l in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[0]["arch"] == "resnet-smoke"
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--arch", "resnet50", "--bf16"])


def test_entry_point_refuses_a_missing_card():
    """Without `--device cpu` the trainer asks for CUDA and raises where
    there is none (a CPU-only machine; on a card it trains)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "resnet50", "--smoke", "--steps", "1"],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
