"""The port's compiled kernel on the card.  Every test here needs CUDA
and `nvcc`, is marked `cuda`, and skips where there is no card.  This file
imports neither jax nor the reference, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 / bf16 3e-2 on the conv (the reference sweep's);
dx/dw 1e-4 of the largest gradient (cuDNN's reductions in another order,
TF32 off); smoke-training losses rtol 1e-4 against the CPU run.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import ops
from repro_torch.kernels.ref import conv2d_ref
from repro_torch.launch import train as train_cli

torch.set_num_threads(2)

# the reference sweep and the meshnet edge shapes (C=18 at stride 2, the
# F=1 1x1 pred conv, prime H_out / W_out, odd extents at stride 2)
SHAPES = [
    (18, 16, 8, 16, 3, 1), (33, 16, 4, 8, 3, 2), (16, 12, 3, 5, 1, 1),
    (23, 9, 6, 128, 7, 2), (12, 8, 16, 256, 3, 1), (9, 9, 2, 3, 5, 1),
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (15, 19, 5, 7, 3, 1),
    (21, 13, 6, 9, 3, 2),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(h, w, c, f, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, f)) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,f,k,s", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(cuda, h, w, c, f, k, s, dtype):
    x, wt = _inputs(h, w, c, f, k)
    tdt = getattr(torch, dtype)
    xd = torch.from_numpy(x).to(cuda, tdt)
    wd = torch.from_numpy(wt).to(cuda, tdt)
    before = tconv.conv2d.launches
    got = ops.conv2d(xd, wd, stride=s)
    torch.cuda.synchronize()
    assert tconv.conv2d.launches == before + 1
    assert got.dtype == tdt and got.is_cuda
    want = conv2d_ref(xd, wd, stride=s)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,f,k,s", [
    (17, 17, 18, 8, 3, 2), (8, 8, 32, 1, 1, 1), (21, 13, 6, 9, 3, 2)])
def test_function_grads_match_plain(cuda, h, w, c, f, k, s):
    x, wt = _inputs(h, w, c, f, k, seed=1)
    grads = []
    for fwd in (lambda a, b: tconv.Conv2d.apply(a, b, s),
                lambda a, b: conv2d_ref(a, b, stride=s)):
        a = torch.from_numpy(x).to(cuda).requires_grad_()
        b = torch.from_numpy(wt).to(cuda).requires_grad_()
        y = fwd(a, b)
        g = torch.linspace(-1, 1, y.numel(), device=cuda).reshape(y.shape)
        (y * g).sum().backward()
        grads.append((a.grad.cpu().numpy(), b.grad.cpu().numpy()))
    for got, want in zip(grads[0], grads[1]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 6, 6, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv2d(x.permute(0, 2, 1, 3), w)
    with pytest.raises(TypeError):
        tconv.conv2d(x.half(), w.half())
    with pytest.raises(ValueError):
        tconv.conv2d(x, w.cpu())


@pytest.mark.cuda
def test_smoke_training_runs_through_the_kernel(cuda):
    argv = ["--arch", "mesh1k", "--smoke", "--steps", "2", "--batch", "2",
            "--log-every", "1"]
    ops.reset_launch_counts()
    on_card = train_cli.main(argv + ["--device", "cuda"])
    assert ops.launch_counts()["conv2d"] == 4 * 2     # 4 convs x 2 steps
    on_cpu = train_cli.main(argv + ["--device", "cpu"])
    assert ops.launch_counts()["conv2d"] == 4 * 2
    np.testing.assert_allclose(on_card["losses"], on_cpu["losses"],
                               rtol=1e-4)
