"""C1: the hand-written 3 x 3 f32 convolution of SuperPoint's trunk
(``ops/frontend_kernels.conv3x3``, csrc/conv3x3.cu).

On the CPU: the dispatcher sends CPU tensors to the plain version and
anything else to the kernel, counting launches; the re-laid weights hold
the kernel's indexing (checked against a float64 numpy convolution that
reads them as the kernel does); ``SuperPoint.forward`` calls C1 for exactly
its nine 3 x 3 convolutions with 64 or more input channels, and not for
``conv1a``, the 1 x 1 heads, bf16, autograd, the CPU or with ``c1``
cleared; ``LoopCam``'s RGB-D batch runs it and ``OmniLoopCam``'s stereo
batch (f16 outputs) keeps cuDNN; the
module's cached re-layout is made once and made again after the weights
are loaded or written; the wrapper's refusals; the tile chosen from the
shape. On a card
(marked ``cuda``; they skip here): the kernel against PyTorch's direct
convolution at every shape of SuperPoint's nine convolutions in the three
benchmark cells (at reduced batch; two calls bit-equal), ragged H and W on
both tiles, NaN and Inf propagation, nine launches a forward.

The file imports no JAX, so it also runs on a card without it:
``python -m pytest --noconftest tests/test_torch_conv3x3.py -m cuda``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from omniswarm_torch import kernels
from omniswarm_torch.models import superpoint
from omniswarm_torch.ops import frontend_kernels as fk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# SuperPoint's convolutions that run C1, in forward order
C1_CONVS = ("conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a",
            "conv4b", "convPa", "convDa")


def c1_shapes(H: int, W: int):
    """(conv, C, K, h, w) of the nine C1 convolutions of one H x W view."""
    out, h, w = [], H, W
    for names, cin, cout in ((("conv1b",), 64, 64),
                             (("conv2a", "conv2b"), 64, 64),
                             (("conv3a", "conv3b"), 64, 128)):
        for i, name in enumerate(names):
            out.append((name, cin if i == 0 else cout, cout, h, w))
        h, w = h // 2, w // 2
    return out + [("conv4a", 128, 128, h, w), ("conv4b", 128, 128, h, w),
                  ("convPa", 128, 256, h, w), ("convDa", 128, 256, h, w)]


# the three cells' view sizes: the RGB-D camera and the stereo rig
CELL_VIEWS = {"rgbd640": (480, 640), "stereo400": (208, 400)}


def numpy_conv_via_relaid(x: np.ndarray, relaid: np.ndarray) -> np.ndarray:
    """The convolution as the kernel indexes it, in float64:
    out[n, 64 kb + k, y, x] = sum over c, r, s of
    relaid[kb, c, 3 r + s, k] * xpad[n, c, y + r, x + s]."""
    N, C, H, W = x.shape
    KB = relaid.shape[0]
    xp = np.pad(x.astype(np.float64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    out = np.zeros((N, KB * 64, H, W))
    for kb in range(KB):
        for r in range(3):
            for s in range(3):
                tap = relaid[kb, :, 3 * r + s, :].astype(np.float64)  # (C, 64)
                patch = xp[:, :, r:r + H, s:s + W]                   # N C H W
                out[:, 64 * kb:64 * (kb + 1)] += np.einsum(
                    "nchw,ck->nkhw", patch, tap)
    return out


def inputs(N, C, K, H, W, seed=0):
    rng = np.random.default_rng(seed + N + C + K + H + W)
    x = np.maximum(rng.normal(size=(N, C, H, W)), 0).astype(np.float32)
    w = (rng.normal(size=(K, C, 3, 3)) * (2.0 / (9 * C)) ** 0.5).astype(
        np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("N,C,K,H,W", [(1, 8, 64, 5, 7), (2, 16, 128, 9, 13),
                                       (1, 64, 64, 12, 20)], ids=str)
def test_relaid_weights_hold_the_kernel_s_indexing(N, C, K, H, W):
    x, w = inputs(N, C, K, H, W)
    relaid = fk.conv3x3_weight(w)
    assert relaid.shape == (K // 64, C, 9, 64) and relaid.is_contiguous()
    want = numpy_conv_via_relaid(x.numpy(), relaid.numpy())
    got = fk.conv3x3_ref(x, w).double().numpy()
    # f32 sums of 9C products against float64: a few ulps of their size
    scale = numpy_conv_via_relaid(np.abs(x.numpy()),
                                  np.abs(relaid.numpy()))
    assert np.all(np.abs(got - want) <= 9 * C * 2.0 ** -24 * scale + 1e-30)


def test_dispatch_takes_plain_version_on_cpu():
    x, w = inputs(2, 64, 64, 13, 21)
    calls, launches = fk.conv3x3_ref.calls, fk.conv3x3.launches
    got = fk.conv3x3(x, w, fk.conv3x3_weight(w))
    assert fk.conv3x3_ref.calls == calls + 1
    assert fk.conv3x3.launches == launches
    assert torch.equal(got, F.conv2d(x, w, None, 1, 1))


@pytest.mark.parametrize("K", [64, 128])
def test_dispatch_launches_the_kernel_off_the_cpu(monkeypatch, K):
    """A tensor off the CPU (here the meta device) goes to the kernel's
    wrapper with the re-laid weights and counts a launch; the plain
    version does not run."""
    seen = []

    def kernel(x, relaid):
        seen.append(relaid)
        N, _, H, W = x.shape
        return torch.empty((N, relaid.shape[0] * 64, H, W), device=x.device)

    monkeypatch.setattr(kernels, "conv3x3", kernel)
    x = torch.empty((2, 64, 10, 12), device="meta")
    w = torch.empty((K, 64, 3, 3), device="meta")
    relaid = fk.conv3x3_weight(w)
    calls, launches = fk.conv3x3_ref.calls, fk.conv3x3.launches
    out = fk.conv3x3(x, w, relaid)
    assert out.shape == (2, K, 10, 12)
    assert fk.conv3x3.launches == launches + 1
    assert fk.conv3x3_ref.calls == calls
    assert seen == [relaid] and relaid.shape == (K // 64, 64, 9, 64)


def test_dispatch_refuses_autograd_off_the_cpu():
    x = torch.empty((1, 64, 4, 4), device="meta", requires_grad=True)
    w = torch.empty((64, 64, 3, 3), device="meta")
    with pytest.raises(ValueError, match="no backward"):
        fk.conv3x3(x, w, fk.conv3x3_weight(w))


def _net(dtype=torch.float32):
    net = superpoint.init_superpoint(torch.Generator().manual_seed(0))
    for name, *_ in superpoint._CONVS:           # biases that matter
        torch.nn.init.uniform_(getattr(net, name).bias, -0.2, 0.2)
    net.dtype = dtype
    return net.eval()


def _images(B=2, H=32, W=48, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(B, 1, H, W)).astype(np.float32))


def test_superpoint_runs_c1_for_its_nine_convolutions(monkeypatch):
    """On the fused path (forced here; the CPU routes C1 to its plain
    version): C1 for the nine, in order, with the module's cached re-laid
    weights; cuDNN for conv1a and the 1 x 1 heads; 12 epilogues; the
    outputs of the three-op path."""
    net, imgs = _net(), _images()
    with torch.no_grad():
        want = net(imgs, return_logits=True)
    names = {id(getattr(net, n).weight): n for n, *_ in superpoint._CONVS}
    seen = []

    def recording(x, weight, relaid):
        name = names[id(weight)]
        assert relaid is getattr(net, name).relaid_weight()
        seen.append((name, tuple(x.shape[1:])))
        return fk.conv3x3(x, weight, relaid)

    monkeypatch.setattr(superpoint, "fused_epilogue", lambda x: True)
    monkeypatch.setattr(superpoint, "conv3x3", recording)
    calls, launches = fk.conv3x3_ref.calls, fk.conv3x3.launches
    epilogues = fk.conv_epilogue_ref.calls
    with torch.no_grad():
        net.c1 = False
        assert net(imgs)[0].shape == (2, 32, 48)
        assert not seen                           # c1 cleared: cuDNN
        net.c1 = True
        got = net(imgs, return_logits=True)
    assert [s[0] for s in seen] == list(C1_CONVS)
    assert [(C, h, w) for _, (C, h, w) in seen] == [
        (C, h, w) for _, C, _, h, w in c1_shapes(32, 48)]
    assert fk.conv3x3_ref.calls == calls + 9
    assert fk.conv3x3.launches == launches
    assert fk.conv_epilogue_ref.calls == epilogues + 24
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_depth_batch_runs_c1_and_the_stereo_batch_keeps_cudnn(monkeypatch):
    """On the fused path (forced here): ``LoopCam``'s RGB-D batch runs C1
    nine times a SuperPoint forward, and so does its stereo batch;
    ``OmniLoopCam``'s stereo batch, whose outputs leave the device in f16
    and are held to cuDNN's bits, keeps cuDNN (its 12 epilogues still
    fused)."""
    from benchmark.frozen import depth_world, image_world, simulator
    from omniswarm_torch.config import FrontendParams
    from omniswarm_torch.swarm.loop_cam import (CameraIntrinsics, LoopCam,
                                                OmniLoopCam)

    h, w, fx = 96, 128, 77.0
    sim = simulator.generate(simulator.SimParams(
        num_drones=2, num_frames=1, seed=4, radius_range=(2.0, 3.5),
        z_range=(0.8, 2.0)))
    [step] = depth_world.render_rgbd(
        sim.gt, [0], fx, fx, h, w, image_world.RoomWorld(half=6.0, seed=4),
        {"noise_per_m2": 0.004, "hole_share": 0.1, "hole_block": 8}, 4,
        "cpu")
    kw = dict(params=FrontendParams(height=h, width=w),
              intrinsics=CameraIntrinsics(fx, fx, w / 2, h / 2), device="cpu")
    cam, omni = LoopCam(**kw), OmniLoopCam(**kw)
    monkeypatch.setattr(superpoint, "fused_epilogue", lambda x: True)
    calls, epilogues = fk.conv3x3_ref.calls, fk.conv_epilogue_ref.calls
    kfs = cam.on_depth_frames_batch([(d, 10, 5.0, sim.vio[0][d], g, z)
                                     for d, (g, z) in enumerate(step)])
    assert len(kfs) == 2
    assert fk.conv3x3_ref.calls == calls + 9
    assert fk.conv_epilogue_ref.calls == epilogues + 12
    grays = np.stack([g for g, _ in step])
    omni.extract_stereo_batch(grays, grays[::-1].copy())
    assert fk.conv3x3_ref.calls == calls + 9
    assert fk.conv_epilogue_ref.calls == epilogues + 24
    cam.extract_stereo_batch(grays, grays[::-1].copy())
    assert fk.conv3x3_ref.calls == calls + 18
    assert fk.conv_epilogue_ref.calls == epilogues + 36


@pytest.mark.parametrize("mode", ["cpu_no_grad", "cpu_grad", "cpu_bf16"])
def test_path_rule_keeps_cudnn(mode):
    """Off the fused path (the CPU, autograd, the bf16 trunk) no
    convolution goes through C1 or its plain version."""
    net, imgs = _net(torch.bfloat16 if mode == "cpu_bf16" else
                     torch.float32), _images()
    calls, launches = fk.conv3x3_ref.calls, fk.conv3x3.launches
    with torch.set_grad_enabled(mode == "cpu_grad"):
        heat, _ = net(imgs)
    assert fk.conv3x3_ref.calls == calls and fk.conv3x3.launches == launches
    if mode == "cpu_grad":
        heat.sum().backward()
        assert net.conv1b.weight.grad is not None


def test_relaid_weight_cached_until_the_weights_change():
    net = _net()
    conv = net.conv3b
    first = conv.relaid_weight()
    assert conv.relaid_weight() is first
    assert torch.equal(first, fk.conv3x3_weight(conv.weight))
    # loading weights again (an in-place copy into the same parameter)
    other = superpoint.init_superpoint(torch.Generator().manual_seed(1))
    net.load_state_dict(other.state_dict())
    again = conv.relaid_weight()
    assert again is not first
    assert torch.equal(again, fk.conv3x3_weight(other.conv3b.weight))
    assert not torch.equal(again, first)
    # any other in-place write
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert torch.equal(conv.relaid_weight(), 2.0 * again)
    assert conv.relaid_weight() is conv.relaid_weight()
    assert "_relaid" not in dict(net.state_dict())


def test_relaid_weight_follows_a_new_parameter():
    """A module moved or given a new weight tensor re-lays that one."""
    net = _net()
    conv = net.conv2a
    first = conv.relaid_weight()
    conv.weight = torch.nn.Parameter(conv.weight.detach() + 1.0)
    assert torch.equal(conv.relaid_weight(), first + 1.0)
    net.double()
    assert conv.relaid_weight().dtype == torch.float64


@pytest.mark.parametrize("case", [
    "cpu", "not_4d", "channels_not_multiple_of_8", "weights_not_relaid",
    "weights_of_other_channels", "float64", "not_contiguous"])
def test_kernel_wrapper_refuses(case):
    x = torch.zeros((2, 64, 8, 8))
    w = fk.conv3x3_weight(torch.zeros((64, 64, 3, 3)))
    match = {"cpu": "CUDA", "not_4d": "(N, C, H, W)",
             "channels_not_multiple_of_8": "multiple of 8",
             "weights_not_relaid": "re-laid",
             "weights_of_other_channels": "re-laid", "float64": "float32",
             "not_contiguous": "contiguous"}[case]
    if case == "not_4d":
        x = x[0]
    elif case == "channels_not_multiple_of_8":
        x = torch.zeros((2, 12, 8, 8))
    elif case == "weights_not_relaid":
        w = torch.zeros((64, 64, 3, 3))
    elif case == "weights_of_other_channels":
        w = fk.conv3x3_weight(torch.zeros((64, 32, 3, 3)))
    elif case == "float64":
        x, w = x.double(), w.double()
    elif case == "not_contiguous":
        x = torch.zeros((2, 64, 8, 16))[..., ::2]
    with pytest.raises(ValueError, match=re.escape(match)):
        kernels.conv3x3(x, w)


@pytest.mark.parametrize("shape", [(64, 64, 5, 5), (64, 64, 1, 1),
                                   (65, 64, 3, 3), (64, 64, 3)], ids=str)
def test_relayout_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        fk.conv3x3_weight(torch.zeros(shape))


@pytest.mark.parametrize("H,W,tile", [
    (480, 640, (8, 32)), (240, 320, (8, 32)), (120, 160, (8, 32)),
    (60, 80, (16, 16)), (208, 400, (16, 16)), (104, 200, (8, 32)),
    (52, 100, (8, 32)), (26, 50, (8, 32)), (61, 83, (8, 32)),
    (50, 70, (16, 16))], ids=str)
def test_tile_chosen_from_the_shape(H, W, tile):
    """The tile that covers the fewest pixels, 8 x 32 on a tie."""
    assert kernels.conv3x3_tile(H, W) == tile
    covered = {t: -(-H // t[0]) * t[0] * -(-W // t[1]) * t[1]
               for t in kernels.CONV3X3_TILES}
    assert covered[tile] == min(covered.values())


def test_kernel_is_built_with_the_others_in_f32_fmas():
    """Built with K1-K3 and E1 by ``kernels.build``; one __global__
    function whose name none of the benchmark's kernel-name readers
    (``grid_nms``, ``retrieval``, ``conv_epilogue``) matches; no tensor-core
    instruction, TF32 conversion or fast-math intrinsic in the source."""
    src = kernels.SOURCES["conv3x3"]
    assert src == ROOT / "omniswarm_torch/csrc/conv3x3.cu"
    text = src.read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\s*\(", text)
    assert names == ["conv3x3_kernel"]
    assert not any(k in names[0] for k in ("grid_nms", "retrieval",
                                           "conv_epilogue"))
    code = re.sub(r"//[^\n]*", "", text)
    for banned in ("mma", "tf32", "wmma", "__fmul_rn", "__fmaf_r",
                   "atomic"):
        assert banned not in code.lower(), banned
    assert "fmaf(" in code
    assert "--use_fast_math" not in kernels.NVCC_FLAGS


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _direct(x, w):
    """PyTorch's direct convolution (cuDNN off: im2col and an f32 GEMM,
    TF32 off), whose error is bounded term by term, unlike cuDNN's FFT
    path."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, w, None, 1, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _bound(x, w):
    """Twice the standard bound of an f32 sum of n = 9C products,
    n 2^-24 sum |w_i x_i|, one for each side: any order of the same
    products and sums lies within it of any other."""
    C = x.shape[1]
    return 2 * 9 * C * 2.0 ** -24 * _direct(x.abs(), w.abs())


def _card_inputs(N, C, K, H, W, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed + C + K + H + W)
    x = torch.randn((N, C, H, W), generator=g, device=device).relu_()
    w = torch.randn((K, C, 3, 3), generator=g, device=device) * (
        2.0 / (9 * C)) ** 0.5
    return x, w


def _main_path_cases():
    out = []
    for view, (H, W) in CELL_VIEWS.items():
        for name, C, K, h, w in c1_shapes(H, W):
            if name in ("conv2b", "conv4b", "convDa"):   # shapes seen above
                continue
            out.append(pytest.param(1 if view == "rgbd640" else 2, C, K, h,
                                    w, id=f"{view}-{name}"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,K,H,W", _main_path_cases())
def test_kernel_matches_the_direct_convolution(cuda_device, record_property,
                                               N, C, K, H, W):
    x, w = _card_inputs(N, C, K, H, W, cuda_device)
    wr = fk.conv3x3_weight(w)
    got = kernels.conv3x3(x, wr)
    again = kernels.conv3x3(x, wr)
    want = _direct(x, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err, bound = (got - want).abs(), _bound(x, w)
    assert bool((err <= bound).all())
    assert torch.equal(got, again)
    # the error as a share of its bound, where the bound is not 0
    record_property("max_err_over_bound",
                    float((err / bound)[bound > 0].max()))


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,K,H,W,tile", [
    (2, 64, 64, 61, 83, (8, 32)), (2, 64, 128, 50, 70, (16, 16)),
    (1, 8, 64, 5, 7, (8, 32)), (3, 16, 192, 17, 9, (16, 16)),
    (1, 128, 256, 1, 1, (8, 32)), (2, 64, 64, 61, 82, (8, 32))], ids=str)
def test_kernel_ragged_edges(cuda_device, N, C, K, H, W, tile):
    """H and W not multiples of the tile, on both tiles; W % 4 != 0 (the
    single stores); a 1 x 1 map (only the pad around it)."""
    assert kernels.conv3x3_tile(H, W) == tile
    x, w = _card_inputs(N, C, K, H, W, cuda_device)
    got = kernels.conv3x3(x, fk.conv3x3_weight(w))
    want = _direct(x, w)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= _bound(x, w)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(61, 83), (50, 70)], ids=str)
def test_kernel_propagates_nan_and_inf(cuda_device, H, W):
    """A NaN input makes its 3 x 3 neighbourhood NaN in every output
    channel and nothing else; a +inf input with positive weights makes its
    neighbourhood +inf; the zero pad brings no NaN to the border."""
    x, w = _card_inputs(1, 64, 64, H, W, cuda_device)
    w = w.abs() + 1e-3
    x[0, 5, 20, 30] = float("nan")
    x[0, 40, H - 1, 0] = float("inf")           # on the border
    got = kernels.conv3x3(x, fk.conv3x3_weight(w))
    torch.cuda.synchronize()
    nan = torch.zeros((H, W), dtype=torch.bool, device=cuda_device)
    nan[19:22, 29:32] = True
    inf = torch.zeros_like(nan)
    inf[H - 2:H, 0:2] = True
    assert bool(torch.isnan(got[0]).eq(nan).all())
    assert bool(torch.isposinf(got[0]).eq(inf).all())
    clean = x.clone()
    clean[0, 5, 20, 30] = clean[0, 40, H - 1, 0] = 0.0
    fin = ~(nan | inf)
    want = _direct(clean, w)
    assert bool(((got - want).abs() <= _bound(clean, w))[:, :, fin].all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,K,H,W", [(1, 64, 64, 480, 640),
                                       (4, 128, 256, 26, 50)], ids=str)
def test_two_calls_bit_equal(cuda_device, N, C, K, H, W):
    x, w = _card_inputs(N, C, K, H, W, cuda_device)
    wr = fk.conv3x3_weight(w)
    a = kernels.conv3x3(x, wr)
    b = kernels.conv3x3(x, wr)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "grad", "bf16"])
def test_nine_launches_a_forward_on_the_rule(cuda_device, mode):
    net = _net(torch.bfloat16 if mode == "bf16" else torch.float32).to(
        cuda_device)
    imgs = _images(4, 64, 96).to(cuda_device)
    launches = fk.conv3x3.launches
    with torch.set_grad_enabled(mode == "grad"):
        heat, desc = net(imgs)
    torch.cuda.synchronize()
    assert fk.conv3x3.launches == launches + (9 if mode == "no_grad" else 0)
    assert bool(torch.isfinite(heat).all() and torch.isfinite(desc).all())
