"""The port's conv kernel module against the reference's Pallas kernel.

On the CPU, `repro_torch.kernels.ops.conv2d` runs the plain version; the
same numpy inputs go through `repro.kernels.conv2d.conv2d(interpret=True)`.
Tolerances are the reference's own sweep's: 2e-5 in f32, 3e-2 in bf16 (one
bf16 rounding of the output).  The compiled kernel is held against the
plain version in tests/test_torch_cuda.py, which needs the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.conv2d import conv2d as pallas_conv2d
from repro_torch.kernels import _build, ops
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels.ref import conv2d_ref

torch.set_num_threads(2)

# tests/test_kernels.py's sweep, then the meshnet edge shapes: C=18 at
# stride 2 (first layer), the F=1 1x1 pred conv, a prime H_out and W_out,
# and a stride-2 layer with odd extents
SHAPES = [
    (18, 16, 8, 16, 3, 1), (33, 16, 4, 8, 3, 2), (16, 12, 3, 5, 1, 1),
    (23, 9, 6, 128, 7, 2), (12, 8, 16, 256, 3, 1), (9, 9, 2, 3, 5, 1),
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (15, 19, 5, 7, 3, 1),
    (21, 13, 6, 9, 3, 2),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(h, w, c, f, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("h,w,c,f,k,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_matches_pallas(h, w, c, f, k, s, dtype):
    x, wt = _inputs(h, w, c, f, k)
    want = pallas_conv2d(jnp.asarray(x, dtype), jnp.asarray(wt, dtype),
                         stride=s, interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.conv2d(torch.from_numpy(x).to(tdt),
                     torch.from_numpy(wt).to(tdt), stride=s)
    assert got.dtype == tdt
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("h,w,c,f,k,s", [
    (18, 16, 8, 16, 3, 1), (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1),
    (21, 13, 6, 9, 3, 2)])
def test_conv2d_function_grads_match_jax(h, w, c, f, k, s):
    """The autograd Function's dx and dw (PyTorch's conv gradients) against
    jax.grad of the reference oracle, through a random cotangent.  fp32
    sums of at most K*K*max(C, F) terms: rtol/atol 2e-5."""
    x, wt = _inputs(h, w, c, f, k, seed=1)
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    g = np.random.default_rng(2).standard_normal((2, ho, wo, f)) \
        .astype(np.float32)
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(jref.conv2d_ref(a, b, stride=s) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    y = tconv.Conv2d.apply(tx, tw, s)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=2e-5, atol=2e-5)


def test_conv2d_ref_matches_jax_oracle():
    """The plain version against the reference's plain version at a
    stride-2 SAME-padded meshnet head shape."""
    x, wt = _inputs(33, 33, 18, 16, 3, seed=3)
    want = jref.conv2d_ref(jnp.asarray(x), jnp.asarray(wt), stride=2)
    got = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt), stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["rank", "dtype", "channels", "layout",
                                 "stride", "small"])
def test_conv2d_checks_raise(bad):
    x = torch.zeros(1, 6, 6, 4)
    w = torch.zeros(3, 3, 4, 8)
    s = 1
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "channels":
        w = torch.zeros(3, 3, 5, 8)
    elif bad == "layout":
        x = x.permute(0, 2, 1, 3)
    elif bad == "stride":
        s = 0
    elif bad == "small":
        w = torch.zeros(7, 7, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        ops.conv2d(x, w, stride=s)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back to the plain version: a CPU
    tensor raises, and the launch count stays put."""
    before = tconv.conv2d.launches
    with pytest.raises(ValueError, match="CUDA"):
        tconv.conv2d(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 4, 4))
    assert tconv.conv2d.launches == before
    ops.conv2d(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 4, 4))
    assert ops.launch_counts()["conv2d"] == before


def test_build_command_and_cache_key(monkeypatch, tmp_path):
    """nvcc is asked for sm_90a, a shared library, and the ptxas report;
    the library name changes with the source."""
    cmd = _build.nvcc_command("nvcc", _build.CSRC / "conv2d.cu",
                              tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    p1 = _build.library_path("conv2d")
    assert p1.parent == _build.BUILD_DIR and p1.suffix == ".so"
    src = tmp_path / "conv2d.cu"
    src.write_text("// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path("conv2d") != p1


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
