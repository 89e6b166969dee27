"""The fused epilogue of SuperPoint's convolutions: bias, ReLU and 2 x 2
max-pool in one pass (``ops/frontend_kernels.conv_epilogue``,
csrc/conv_epilogue.cu).

On the CPU: the plain version against numpy (an f32 add, NaN-propagating
maxima, a floored 2 x 2 pool) and against the three PyTorch ops, over the
three cases, odd H and W, W % 4 != 0 and C = 65, with NaN and +-inf planted
inside and on the border of pooling windows; the path rule (no launch on
the CPU, under autograd or in bf16); the model's 12 epilogues, routed
through the plain version; the wrappers' refusals; the benchmark's
``epilogue_roofline`` reader. On a card (marked ``cuda``; they skip here):
the kernel bit-equal to the plain version at the main path's 12 shapes at
80 views and at odd, unaligned and NaN cases, the extractor's outputs equal
between the fused and the plain path on 80 rendered views, and 12 launches
a forward.

The file imports no JAX, so it also runs on a card without it:
``python -m pytest --noconftest tests/test_torch_conv_epilogue.py -m cuda``.
"""
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.frozen.trace import Trace
from omniswarm_torch import kernels
from omniswarm_torch.models import superpoint
from omniswarm_torch.ops import frontend_kernels as fk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CASES = [(False, False), (True, False), (True, True)]
CASE_IDS = ["bias", "bias_relu", "bias_relu_pool"]
# odd H and W, W % 4 != 0 (H * W % 4 == 0 or not), C = 65, a 2 x 2 map
ODD_SHAPES = [(2, 65, 26, 50), (1, 3, 7, 9), (2, 4, 6, 14), (1, 5, 5, 6),
              (2, 2, 2, 2), (1, 64, 16, 20)]


def main_path_epilogues(B: int, H: int, W: int):
    """(conv, conv output shape, relu, pool) of SuperPoint's 12
    epilogues, in order, for B views of H x W."""
    out, h, w = [], H, W
    for a, b, c in (("conv1a", "conv1b", 64), ("conv2a", "conv2b", 64),
                    ("conv3a", "conv3b", 128)):
        out += [(a, (B, c, h, w), True, False), (b, (B, c, h, w), True, True)]
        h, w = h // 2, w // 2
    return out + [("conv4a", (B, 128, h, w), True, False),
                  ("conv4b", (B, 128, h, w), True, False),
                  ("convPa", (B, 256, h, w), True, False),
                  ("convPb", (B, 65, h, w), False, False),
                  ("convDa", (B, 256, h, w), True, False),
                  ("convDb", (B, 256, h, w), False, False)]


def numpy_epilogue(x, b, relu, pool):
    y = x + b[None, :, None, None]                 # f32: one rounding
    if relu:
        y = np.maximum(y, np.float32(0))            # NaN propagates
    if pool:
        N, C, H, W = y.shape
        Ho, Wo = H // 2, W // 2
        y = y[:, :, :2 * Ho, :2 * Wo].reshape(N, C, Ho, 2, Wo, 2)
        y = y.max(axis=(3, 5))                      # NaN propagates
    return y


def inputs(shape, kind, seed=0):
    """Normal f32 conv outputs and biases; ``special`` plants NaN, +inf
    and -inf at window corners, inside and on the map's border, and in an
    odd map's last row and column (which the pool drops)."""
    rng = np.random.default_rng(seed + sum(shape))
    N, C, H, W = shape
    x = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(0, 0.5, size=C).astype(np.float32)
    if kind == "special":
        x[:, 0, 0, 0] = np.nan                      # the first window
        x[:, -1, H - 1, W - 1] = np.nan             # dropped when odd
        x[0, C // 2, H // 2, W // 2] = np.inf
        x[0, C // 2, 0, W - 1] = -np.inf            # border, last window
        x[-1, 0, H - 1, 0] = np.inf
        x[-1, -1, H // 3, W // 3] = np.nan
        x[0, -1, 1, 1] = -np.inf                    # a window's inner corner
    return x, b


def same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal shapes, NaN where the other has NaN, equal values elsewhere
    (+0 equal to -0, as ``torch.equal``)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


@pytest.mark.parametrize("relu,pool", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["random", "special"])
def test_plain_matches_numpy_and_the_three_ops(shape, relu, pool, kind):
    x, b = inputs(shape, kind)
    x0 = x.copy()
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    got = fk.conv_epilogue_ref(tx, tb, relu, pool)
    want = numpy_epilogue(x, b, relu, pool)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)     # NaN equals NaN
    np.testing.assert_array_equal(x, x0)                 # x is kept
    ops = tx + tb.view(1, -1, 1, 1)
    if relu:
        ops = F.relu(ops)
    if pool:
        ops = F.max_pool2d(ops, 2, 2)
    assert same(got, ops)
    if kind == "special":
        assert torch.isnan(got[:, 0, 0, 0]).all()       # the first window
        if pool and shape[2] % 2 and shape[3] % 2:      # dropped NaN
            assert not torch.isnan(got[:, -1, -1, -1]).any()


def test_dispatch_takes_plain_version_on_cpu():
    x, b = inputs((2, 65, 26, 50), "random")
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    calls, launches = fk.conv_epilogue_ref.calls, fk.conv_epilogue.launches
    got = fk.conv_epilogue(tx, tb, True, True)
    assert fk.conv_epilogue_ref.calls == calls + 1
    assert fk.conv_epilogue.launches == launches
    assert torch.equal(got, fk.conv_epilogue_ref(tx, tb, True, True))


def _net(dtype=torch.float32):
    net = superpoint.init_superpoint(torch.Generator().manual_seed(0))
    for name, *_ in superpoint._CONVS:           # biases that matter
        torch.nn.init.uniform_(getattr(net, name).bias, -0.2, 0.2)
    net.dtype = dtype
    return net.eval()


def _images(B=2, H=32, W=48, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(B, 1, H, W)).astype(np.float32))


@pytest.mark.parametrize("mode", ["cpu_no_grad", "cpu_grad", "cpu_bf16"])
def test_path_rule_keeps_the_pytorch_ops(mode):
    net, imgs = _net(torch.bfloat16 if mode == "cpu_bf16" else
                     torch.float32), _images()
    calls, launches = fk.conv_epilogue_ref.calls, fk.conv_epilogue.launches
    with torch.set_grad_enabled(mode == "cpu_grad"):
        assert not superpoint.fused_epilogue(imgs.to(net.dtype))
        heat, desc = net(imgs)
    assert fk.conv_epilogue.launches == launches
    assert fk.conv_epilogue_ref.calls == calls     # the three ops, not it
    assert heat.dtype == desc.dtype == torch.float32
    if mode == "cpu_grad":
        heat.sum().backward()
        assert net.conv1a.bias.grad is not None


def test_fused_composition_through_plain_version(monkeypatch):
    """The fused path's 12 epilogues, each convolution without its bias,
    routed on the CPU through the plain version: the cases in order, and
    the heat map and descriptors of the three-op path."""
    net, imgs = _net(), _images()
    with torch.no_grad():
        want = net(imgs, return_logits=True)
    seen = []

    def recording(x, bias, relu, pool):
        seen.append((tuple(x.shape), relu, pool))
        return fk.conv_epilogue(x, bias, relu, pool)

    monkeypatch.setattr(superpoint, "fused_epilogue", lambda x: True)
    monkeypatch.setattr(superpoint, "conv_epilogue", recording)
    calls = fk.conv_epilogue_ref.calls
    with torch.no_grad():
        got = net(imgs, return_logits=True)
    assert fk.conv_epilogue_ref.calls == calls + 12
    assert seen == [(s, r, p) for _, s, r, p in main_path_epilogues(2, 32,
                                                                     48)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,bias_shape,relu,pool", [
    ((2, 4, 8, 8), (4,), True, True),           # a CPU tensor
    ((4, 8, 8), (4,), True, False),             # not 4-D
    ((2, 4, 8, 8), (5,), True, False),          # bias of another width
    ((2, 4, 8, 8), (4,), False, True),          # pool without the ReLU
    ((2, 4, 1, 8), (4,), True, True),           # an empty pool
    ((2, 0, 8, 8), (0,), True, False)])         # an empty map
def test_kernel_wrapper_refuses(shape, bias_shape, relu, pool):
    with pytest.raises(ValueError):
        kernels.conv_epilogue(torch.zeros(shape), torch.zeros(bias_shape),
                              relu, pool)


def test_kernel_is_built_with_the_others_under_the_metric_s_name():
    """Built with K1-K3; its __global__ function's name holds the
    ``conv_epilogue`` that ``epilogue_roofline`` finds it by."""
    src = kernels.SOURCES["conv_epilogue"]
    assert src == ROOT / "omniswarm_torch/csrc/conv_epilogue.cu"
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\s*\(", src.read_text())
    assert names == ["conv_epilogue_kernel"]


def _reader():
    path = ROOT / "benchmark/metrics/epilogue_roofline.py"
    spec = importlib.util.spec_from_file_location("epilogue_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(kernel_list, drones=10):
    trace = Trace(kernel_list, [], 0.0, 1.0, [])
    return SimpleNamespace(trace=trace, config=dict(
        swarm=dict(drones=drones), frontend=dict(height=208, width=400)))


def test_epilogue_bytes_from_the_layer_shapes():
    reader = _reader()
    assert reader.view_bytes(208, 400) == 106_506_400
    want = sum(4 * np.prod(s[1:]) * (1.25 if pool else 2)
               for _, s, _, pool in main_path_epilogues(1, 208, 400))
    assert reader.view_bytes(208, 400) == want
    assert reader.view_bytes(96, 160) == sum(
        4 * np.prod(s[1:]) * (1.25 if pool else 2)
        for _, s, _, pool in main_path_epilogues(1, 96, 160))


def test_epilogue_roofline_reads_launches_at_their_bound():
    reader = _reader()
    bound_us = 80 * 106_506_400 / 3.35e12 * 1e6     # one forward, 80 views
    # two forwards of 12 launches at twice the bound, beside other kernels
    ks = [(f"void conv_epilogue_kernel<true, false, true>(...)", 0.0,
           bound_us / 6) for _ in range(24)]
    ks.append(("grid_nms_kernel", 0.0, 1e6))
    assert reader.read(_rec(ks)) == pytest.approx(50.0)
    assert reader.read(_rec(ks[-1:])) is None       # no epilogue kernel
    assert reader.read(SimpleNamespace(trace=None)) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,relu,pool",
                         main_path_epilogues(80, 208, 400),
                         ids=[e[0] for e in main_path_epilogues(1, 1, 1)])
def test_kernel_bit_equal_at_the_main_path(cuda_device, name, shape, relu,
                                           pool):
    g = torch.Generator(device=cuda_device).manual_seed(len(name))
    x = torch.randn(shape, generator=g, device=cuda_device)
    b = 0.5 * torch.randn(shape[1], generator=g, device=cuda_device)
    want = fk.conv_epilogue_ref(x, b, relu, pool)
    xk = x.clone()
    assert kernels.conv_epilogue_vector_width(xk, xk if not pool else
                                              want, pool) == 4
    got = kernels.conv_epilogue(xk, b, relu, pool)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got.data_ptr() == xk.data_ptr()) == (not pool)   # in place


@pytest.mark.cuda
@pytest.mark.parametrize("relu,pool", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["random", "special"])
@pytest.mark.parametrize("aligned", [True, False])
def test_kernel_bit_equal_at_odd_shapes(cuda_device, shape, relu, pool,
                                        kind, aligned):
    x, b = (torch.from_numpy(v).to(cuda_device) for v in inputs(shape, kind))
    want = fk.conv_epilogue_ref(x, b, relu, pool)
    if not aligned:             # a view 4 bytes off 16: the scalar path
        x = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(
            shape).copy_(x)
        assert kernels.conv_epilogue_vector_width(x, x, pool) == 1
    got = kernels.conv_epilogue(x, b, relu, pool)
    torch.cuda.synchronize()
    assert same(got, want)


def _rendered_views(n=80, H=208, W=400):
    from omniswarm_torch.sim.image_world import render_shapes

    rng = np.random.default_rng(5)
    return torch.from_numpy(np.stack([render_shapes(rng, H, W)[0]
                                      for _ in range(n)]))[:, None]


@pytest.mark.cuda
def test_extractor_outputs_equal_fused_and_plain(cuda_device, monkeypatch):
    """The epilogue's own effect: the fused path's convolutions are left
    to cuDNN here (``c1`` cleared, as ``OmniLoopCam`` runs the stereo
    batch) as on the plain path (C1 sums in another order where cuDNN picks
    FFT, see tests/test_torch_conv3x3.py), so the outputs must be equal bit
    for bit."""
    from omniswarm_torch.core.precision import highp

    ext = superpoint.pretrained_extractor(cuda_device)
    imgs = _rendered_views().to(cuda_device)
    launches = fk.conv_epilogue.launches
    with highp():
        ext.net.c1 = False
        fused = ext(imgs)
        assert fk.conv_epilogue.launches == launches + 12
        monkeypatch.setattr(superpoint, "fused_epilogue", lambda x: False)
        plain = ext(imgs)
    torch.cuda.synchronize()
    assert fk.conv_epilogue.launches == launches + 12
    assert bool(fused[3].any())
    for name, f, p in zip(("xy", "scores", "desc", "valid"), fused, plain):
        assert torch.equal(f, p), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "grad", "bf16"])
def test_twelve_launches_a_forward_on_the_rule(cuda_device, mode):
    net = _net(torch.bfloat16 if mode == "bf16" else torch.float32).to(
        cuda_device)
    imgs = _images(4, 64, 96).to(cuda_device)
    launches = fk.conv_epilogue.launches
    with torch.set_grad_enabled(mode == "grad"):
        heat, desc = net(imgs)
    torch.cuda.synchronize()
    assert fk.conv_epilogue.launches == launches + (12 if mode == "no_grad"
                                                    else 0)
    assert bool(torch.isfinite(heat).all() and torch.isfinite(desc).all())
