"""``omniswarm_torch.tools.convert_superpoint`` against the reference's
``tools/convert_superpoint.py``: a seeded SuperPointNet's ``.pth`` (and
PCA CSVs) give the same ``.npz``, key for key and bit for bit, and the
port's ``SuperPoint`` on it matches the network's own forward at
``tests/test_weight_conversion.py``'s bars (atol 1e-4, rtol 1e-3)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch.models.superpoint import (SuperPoint, SuperPointExtractor,
                                               load_params_npz, net_state)
from omniswarm_torch.ops.frontend_kernels import grid_nms, grid_nms_ref
from omniswarm_torch.tools import convert_superpoint as tool

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BARS = dict(atol=1e-4, rtol=1e-3)


def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_convert_superpoint", ROOT / "tools/convert_superpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    net = tool.seeded_twin(3)
    pth = d / "sp.pth"
    torch.save(net.state_dict(), pth)
    rng = np.random.default_rng(0)
    comps = rng.normal(size=(64, 256)).astype(np.float32)
    mean = rng.normal(size=256).astype(np.float32)
    np.savetxt(d / "c.csv", comps, delimiter=",")
    np.savetxt(d / "m.csv", mean[None], delimiter=",")
    return d, net, pth


PCA = {"none": (None, None), "components": ("c.csv", None),
       "both": ("c.csv", "m.csv")}


@pytest.mark.parametrize("pca", sorted(PCA))
def test_npz_bit_equal_to_the_references(artifacts, pca):
    d, _, pth = artifacts
    csvs = [str(d / f) if f else None for f in PCA[pca]]
    ref, got = d / f"ref_{pca}.npz", d / f"port_{pca}.npz"
    reference_tool().convert(str(pth), str(ref), *csvs)
    tool.convert(str(pth), str(got), *csvs)
    a, b = np.load(ref), np.load(got)
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert ("pca_components" in b.files) == (pca != "none")


def test_twin_is_the_reference_tests(artifacts):
    """The module's SuperPointNet is tests/test_weight_conversion.py's."""
    import test_weight_conversion as wc

    _, net, _ = artifacts
    ref = wc.TorchSuperPoint().eval()
    ref.load_state_dict(net.state_dict())
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(2, 1, 32, 48)).astype(np.float32))
    with torch.no_grad():
        for x, y in zip(net(img), ref(img)):
            assert torch.equal(x, y)


def test_port_superpoint_matches_the_twin(artifacts):
    d, net, pth = artifacts
    out = d / "plain.npz"
    tool.convert(str(pth), str(out))
    sp = SuperPoint().eval()
    sp.load_state_dict(net_state(load_params_npz(out)))
    img = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, 1, 32, 48)).astype(np.float32))
    with torch.no_grad():
        got, want = sp(img), net(img)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BARS)


def test_extractor_runs_from_the_converted_npz(artifacts):
    """With the PCA, the extractor loads the file whole; on the CPU its
    NMS is K2's plain version."""
    d, net, pth = artifacts
    out = d / "pca.npz"
    tool.convert(str(pth), str(out), str(d / "c.csv"), str(d / "m.csv"))
    ex = SuperPointExtractor(load_params_npz(out), max_keypoints=16,
                             threshold=0.0).eval()
    img = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, 1, 32, 48)).astype(np.float32))
    k0, p0 = grid_nms.launches, grid_nms_ref.calls
    xy, scores, desc, valid = ex(img)
    assert (grid_nms.launches, grid_nms_ref.calls) == (k0, p0 + 1)
    assert desc.shape == (1, 16, 64) and bool(valid.any())
    heat, _ = net(img)
    assert torch.isfinite(scores).all() and scores.max() <= heat.max()


@pytest.mark.parametrize("out", ["COMM_MODEL.json",
                                 "omniswarm_tpu/models/weights/sp.npz"])
def test_cli_refuses_the_repositorys_artifacts(artifacts, out, capsys):
    _, _, pth = artifacts
    with pytest.raises(SystemExit) as e:
        tool.main(["--pth", str(pth), "--out", str(ROOT / out)])
    assert e.value.code == 2
    assert "reference artifact" in capsys.readouterr().err


def test_cli_writes_the_npz(artifacts):
    d, _, pth = artifacts
    out = d / "cli.npz"
    tool.main(["--pth", str(pth), "--pca-components", str(d / "c.csv"),
               "--out", str(out)])
    raw = np.load(out)
    np.testing.assert_array_equal(raw["pca_mean"], np.zeros(256, np.float32))
    assert raw["pca_components"].shape == (64, 256)
