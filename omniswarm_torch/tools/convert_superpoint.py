"""Convert SuperPoint PyTorch weights (+ PCA CSVs) to the ``.npz``
checkpoint that ``models.superpoint.load_params_npz`` reads.

    python -m omniswarm_torch.tools.convert_superpoint --pth superpoint_v1.pth \\
        [--pca-components components_.csv --pca-mean mean_.csv] \\
        --out superpoint.npz

Counterpart of ``tools/convert_superpoint.py``, with the same flags and the
same output, key for key and bit for bit: the standard SuperPointNet
state dict (``conv1a`` ... ``conv4b``, ``convPa``/``convPb``,
``convDa``/``convDb``, each ``.weight`` in OIHW and ``.bias``) as f32, and
with ``--pca-components`` the (dim, 256) projection and its mean (zeros
without ``--pca-mean``). It runs on the host and takes no device.
``--out`` refuses the repository's artifacts.

``SuperPointNet`` is that standard network in plain PyTorch (encoder and
heads, the detector's softmax and depth-to-space, the descriptors unit
length): the model such a ``.pth`` comes from, against which a converted
checkpoint is checked.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

LAYERS = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
          "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb"]
REFERENCE_OUTPUTS = ("omniswarm_tpu", "*.json")


class SuperPointNet(torch.nn.Module):
    """The standard SuperPointNet: images (B, 1, H, W) -> (heat (B, H, W),
    desc (B, H/8, W/8, 256) channels-last)."""

    def __init__(self):
        super().__init__()
        conv = torch.nn.Conv2d
        widths = (1, 64, 64, 64, 64, 128, 128, 128, 128)
        for name, cin, cout in zip(LAYERS[:8], widths, widths[1:]):
            self.add_module(name, conv(cin, cout, 3, padding=1))
        self.convPa, self.convPb = conv(128, 256, 3, padding=1), conv(256, 65, 1)
        self.convDa, self.convDb = conv(128, 256, 3, padding=1), conv(256, 256, 1)

    def forward(self, x):
        relu = torch.nn.functional.relu
        for k, layer in enumerate(LAYERS[:8]):
            x = relu(getattr(self, layer)(x))
            if k in (1, 3, 5):
                x = torch.nn.functional.max_pool2d(x, 2)
        semi = self.convPb(relu(self.convPa(x)))
        desc = self.convDb(relu(self.convDa(x)))
        desc = desc / desc.norm(dim=1, keepdim=True).clamp(min=1e-8)
        semi = torch.softmax(semi, 1)[:, :64]
        B, _, Hc, Wc = semi.shape
        heat = semi.permute(0, 2, 3, 1).reshape(B, Hc, Wc, 8, 8)
        heat = heat.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)
        return heat, desc.permute(0, 2, 3, 1)


def seeded_twin(seed: int) -> SuperPointNet:
    """A ``SuperPointNet`` with PyTorch's default initialisation drawn
    under ``seed`` (the global generator is left as it was), in eval
    mode, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return SuperPointNet().eval()


def convert(pth_path: str, out_path: str, pca_components: str | None = None,
            pca_mean: str | None = None) -> dict:
    """Write the ``.npz``; returns its arrays by key."""
    state = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    out = {}
    for layer in LAYERS:
        out[f"{layer}.weight"] = state[f"{layer}.weight"].numpy().astype(
            np.float32)
        out[f"{layer}.bias"] = state[f"{layer}.bias"].numpy().astype(
            np.float32)
    if pca_components:
        comps = np.genfromtxt(pca_components, delimiter=",")
        comps = comps.reshape(comps.shape[0], -1).astype(np.float32)
        out["pca_components"] = comps
        if pca_mean:
            mean = np.genfromtxt(pca_mean, delimiter=",").reshape(-1)
            out["pca_mean"] = mean.astype(np.float32)
        else:
            out["pca_mean"] = np.zeros(comps.shape[1], np.float32)
    np.savez(out_path, **out)
    print(f"wrote {out_path}: {sorted(out)}", flush=True)
    return out


def main(argv=None) -> dict:
    from omniswarm_torch.benchutil import refuse_reference_output

    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.convert_superpoint",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--pth", required=True)
    ap.add_argument("--pca-components")
    ap.add_argument("--pca-mean")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    return convert(args.pth, args.out, args.pca_components, args.pca_mean)


if __name__ == "__main__":
    main()
