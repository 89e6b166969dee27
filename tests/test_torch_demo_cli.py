"""The examples' command lines on the port (``omniswarm_torch.demo_entry``)
and the feature demo at the 10-drone tier in both packages.

The parsers are held to the examples' own ``add_argument`` calls, read with
``ast``: every flag with its name and default (``--out`` apart, which
defaults to stdout and never names one of the repository's pre-port demo
artifacts), ``--device`` defaulting to the card, and no other flag. The
10-drone x 12-frame feature session runs in the JAX package (in a fresh
interpreter, started first: late in a full suite a D=10 compile has crashed
XLA-CPU, tests/test_scale10.py:48-55) and in the port, whose detectors draw
the reference's random numbers (``use_jax_draws``): the loops must be equal
loop for loop, every drone's cost within 1% and its relative ATE within
0.05 cm.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from omniswarm_torch import demo_entry
from omniswarm_torch.swarm.node import DroneNode as TDroneNode

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_loop_detector import use_jax_draws  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {"feature": "examples/run_demo.py",
            "image": "examples/run_image_demo.py"}
D10, F10 = 10, 12
COST_RTOL = 0.01
ATE_ATOL_CM = 0.05       # a drone's relative ATE against the reference's
REFERENCE = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tools")
from demo_anchors import anchors_of, reference_kit
from omniswarm_torch.demo_entry import run_feature_demo
res = run_feature_demo(reference_kit(), drones=int(sys.argv[1]),
                       frames=int(sys.argv[2]))
print("REFERENCE", json.dumps(anchors_of(res)))
"""


def example_flags(path: str) -> dict:
    """{option string: default} of every ``add_argument`` call of an
    example (a ``store_false`` flag's default is True)."""
    flags = {}
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else None)
            for arg in node.args:
                flags[ast.literal_eval(arg)] = default
    return flags


def port_flags(demo: str) -> dict:
    """{option string: default} of the port's subcommand ``demo``."""
    sub = next(a for a in demo_entry.parser()._actions
               if a.dest == "demo").choices[demo]
    return {opt: a.default for a in sub._actions for opt in a.option_strings
            if opt not in ("-h", "--help")}


@pytest.mark.parametrize("demo", sorted(EXAMPLES))
def test_parser_takes_the_examples_flags(demo):
    want = example_flags(EXAMPLES[demo])
    got = port_flags(demo)
    assert set(got) == set(want) | {"--device"}
    for flag, default in want.items():
        if flag != "--out":
            assert got[flag] == default, flag
    args = demo_entry.parser().parse_args([demo])
    assert args.out is None and args.device == "cuda"


@pytest.mark.parametrize("demo", sorted(EXAMPLES))
def test_out_never_a_pre_port_file(demo, monkeypatch):
    """The examples' own --out defaults and every IMAGE_DEMO*.json at the
    root are refused before anything runs."""
    ran = []
    monkeypatch.setattr(demo_entry, "feature_demo_entry", ran.append)
    monkeypatch.setattr(demo_entry, "image_demo_entry", ran.append)
    targets = [example_flags(p)["--out"] for p in EXAMPLES.values()]
    targets += [str(p) for p in ROOT.glob("IMAGE_DEMO*.json")]
    targets += [str(ROOT / "demo_out" / "drone0")]
    assert len(targets) >= 5
    for out in targets:
        with pytest.raises(SystemExit):
            demo_entry.main([demo, "--out", out])
    assert ran == []


def run_module(*args, env=None):
    """``python -m omniswarm_torch.demo_entry ARGS`` in a fresh process, on
    one CPU thread as the tests run."""
    return subprocess.run(
        [sys.executable, "-m", "omniswarm_torch.demo_entry", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT),
                           OMP_NUM_THREADS="1", **(env or {})),
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("demo", sorted(EXAMPLES))
def test_cli_raises_without_cuda(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_entry.main([demo, "--drones", "10", "--frames", "30"])


def test_module_raises_without_cuda():
    """``python -m omniswarm_torch.demo_entry image --drones 10 --frames
    30`` with no card visible exits non-zero before rendering, naming
    ``--device cpu``'s keyword."""
    out = run_module("image", "--drones", "10", "--frames", "30",
                     env=dict(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and out.stdout == ""


def test_feature_cli_on_cpu(tmp_path):
    """``python -m omniswarm_torch.demo_entry feature`` end to end at 2
    drones x 6 frames: one JSON line on stdout, each solved drone's report
    under --out."""
    out = run_module("feature", "--drones", "2", "--frames", "6", "--drop",
                     "0", "--device", "cpu", "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["drones"] == 2 and res["frames"] == 6
    for d in res["per_drone"]:
        if d["solved"]:
            assert (tmp_path / f"drone{d['drone']}" / "summary.json").exists()


def test_image_cli_on_cpu(tmp_path, monkeypatch):
    """The image subcommand hands every flag to image_demo_entry and writes
    its metrics to --out, not to stdout."""
    seen = {}

    def fake_entry(device, **kw):
        seen.update(kw, device=device)
        return dict(drones=kw["drones"], estimates=[None])

    monkeypatch.setattr(demo_entry, "image_demo_entry", fake_entry)
    out = tmp_path / "metrics.json"
    res = demo_entry.main(["image", "--drones", "10", "--frames", "30",
                           "--drop", "0.1", "--kf-every", "3",
                           "--candidates", "4", "--no-balanced-db",
                           "--max-loops", "2", "--device", "cpu",
                           "--out", str(out)])
    assert seen == dict(device="cpu", drones=10, frames=30, kf_every=3,
                        drop=0.1, candidates=4, max_loops=2,
                        balanced_db=False)
    assert res == {"drones": 10} == json.loads(out.read_text())


def test_image_fp_defaults_are_the_demos():
    """The flags' defaults give the image demo's FrontendParams, so the D=5
    runs (phase 9a, the anchors) are unchanged."""
    assert demo_entry.image_fp() == demo_entry.IMAGE_FP
    fp = demo_entry.image_fp(candidates=4, max_loops=2, balanced_db=False)
    assert (fp["search_nearest_num"], fp["max_loops_per_query"],
            fp["balanced_db_candidates"]) == (4, 2, False)


@pytest.fixture(scope="module")
def reference_proc():
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(D10), str(F10)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def sessions(reference_proc):
    def node(d, bus, **kw):
        out = TDroneNode(d, bus, **kw)
        use_jax_draws(out.detector, kw["seed"])
        return out

    kit = demo_entry.port_kit(torch.device("cpu"))._replace(DroneNode=node)
    port = demo_entry.run_feature_demo(kit, drones=D10, frames=F10)
    stdout, stderr = reference_proc.communicate(timeout=900)
    assert reference_proc.returncode == 0, stderr[-2000:]
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("REFERENCE"))
    return json.loads(line.split(" ", 1)[1]), port


def test_ten_drone_feature_session_loops_equal(sessions):
    ref, port = sessions
    assert port["drones"] == D10
    assert port["loop_keys"] == ref["loop_keys"]
    assert port["false_keys"] == ref["false_keys"]
    for key in ("loops_found", "loops_received", "revisit_opportunities",
                "loop_recall", "loop_precision", "loop_precision_post_pcm"):
        assert port[key] == ref[key], key
    assert port["loops_unique"] > 0


def test_ten_drone_feature_session_costs(sessions):
    ref, port = sessions
    assert port["all_solved"] and ref["all_solved"]
    for got, want in zip(port["per_drone"], ref["per_drone"], strict=True):
        assert got["drone"] == want["drone"]
        assert got["cost"] == pytest.approx(want["cost"], rel=COST_RTOL)
        assert got["relative_ate_cm"] == pytest.approx(
            want["relative_ate_cm"], abs=ATE_ATOL_CM)
