"""The port's PCA, textured-eval and bus command lines
(``omniswarm_torch/tools/``): ``fit_pca`` against the reference's
``tools/fit_pca.py`` in both output forms, the textured eval's command line
against ``train_entry.textured_eval``, and the two bus tools over loopback
multicast (skipped, as ``tests/test_torch_udp.py`` is, when the host
refuses the socket)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omniswarm_torch.runtime import udp_transport as tudp
from omniswarm_torch.tools import bus_spy, eval_superpoint_textured, fit_pca
from omniswarm_torch.train_entry import textured_eval

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = 17931          # the port's tests' own (tests/test_torch_udp.py)
WEIGHTS = ROOT / "omniswarm_tpu/models/weights"


def reference_fit_pca():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import fit_pca as ref
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return ref


@pytest.fixture
def desc(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 256)) @ rng.normal(size=(256, 256)) / 16
    path = tmp_path / "desc.npy"
    np.save(path, x.astype(np.float32))
    return path


def test_fit_pca_csv_matches_reference(desc, tmp_path):
    comps, mean, ratio = fit_pca.main([
        "--desc", str(desc), "--dim", "64",
        "--out-components", str(tmp_path / "c.csv"),
        "--out-mean", str(tmp_path / "m.csv")])
    rc, rm, rr = reference_fit_pca().fit_pca(np.load(desc), 64)
    np.testing.assert_allclose(comps, rc, atol=1e-6)
    np.testing.assert_allclose(mean, rm, atol=1e-6)
    np.testing.assert_allclose(ratio, rr, atol=1e-6)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "c.csv", delimiter=","),
                               rc, atol=1e-6)
    m = np.loadtxt(tmp_path / "m.csv", delimiter=",")
    assert m.shape == (256,)
    np.testing.assert_allclose(m, rm, atol=1e-6)


@pytest.mark.parametrize("flax_style", [True, False])
def test_fit_pca_npz_matches_reference(desc, tmp_path, flax_style,
                                       monkeypatch):
    """The projection added to a checkpoint: dunder keys in a Flax-style
    one, plain keys otherwise, an earlier projection replaced."""
    base = {"params/conv1a/kernel": np.ones((3, 3, 1, 64), np.float32)} \
        if flax_style else {"conv1a.weight": np.ones((64, 1, 3, 3),
                                                     np.float32)}
    base["pca_components"] = np.zeros((2, 2), np.float32)
    paths = {}
    for who in ("port", "ref"):
        paths[who] = tmp_path / f"{who}.npz"
        np.savez(paths[who], **base)
    fit_pca.main(["--desc", str(desc), "--dim", "64",
                  "--out-npz", str(paths["port"])])
    monkeypatch.setattr(sys, "argv", ["fit_pca.py", "--desc", str(desc),
                                      "--dim", "64", "--out-npz",
                                      str(paths["ref"])])
    reference_fit_pca().main()
    got, want = np.load(paths["port"]), np.load(paths["ref"])
    assert sorted(got.files) == sorted(want.files)
    pfx = "__" if flax_style else ""
    assert {pfx + "pca_components", pfx + "pca_mean"} <= set(got.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_textured_eval_cli_matches_function(tmp_path):
    out = tmp_path / "sp_eval.json"
    got = eval_superpoint_textured.main([
        "--ckpt", "magicpoint=weights/superpoint_synthetic.npz",
        "--n-eval", "2", "--device", "cpu", "--out", str(out)])
    want = textured_eval(
        {"magicpoint": str(WEIGHTS / "superpoint_synthetic.npz")},
        n_eval=2, device="cpu")
    assert got["checkpoints"] == want
    assert json.loads(out.read_text()) == got
    assert set(got["checkpoints"]["magicpoint"]) == {
        "textured_match_precision", "textured_matches",
        "flat_match_precision", "flat_matches"}
    with pytest.raises(SystemExit):
        eval_superpoint_textured.main(["--ckpt", "a=b.npz", "--out",
                                       str(ROOT / "SP_EVAL_r05.json")])


def test_bus_tools_over_loopback():
    """Two ``python -m omniswarm_torch.tools.network_tester`` processes and
    the spy on one port for a few seconds: each tester receives the other's
    keyframes, the spy hears both senders on the keyframe channels."""
    try:
        tudp.UdpMulticastBus(port=PORT).close()
    except OSError as e:
        pytest.skip(f"multicast unavailable on this host: {e}")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "omniswarm_torch.tools.network_tester",
         "--drone-id", str(d), "--rate", "2", "--duration", "4", "--port",
         str(PORT)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, text=True) for d in (0, 1)]
    spied = bus_spy.spy(port=PORT, interval=1.0, duration=6.0)
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    for me, out in enumerate(outs):
        sent, received = map(int, re.search(
            r"sent (\d+) keyframes; received (\d+) from peers", out).groups())
        rate = float(re.search(rf"drone {1 - me}: receive rate ([\d.]+)%",
                               out).group(1))
        assert sent >= 6 and received >= 1 and rate > 0, out
    assert set(spied["senders"]) == {0, 1}
    assert spied["channels"]["VIOKF_HEADER"] >= 2
    assert spied["channels"]["VIOKF_LANDMARKS"] > 0
