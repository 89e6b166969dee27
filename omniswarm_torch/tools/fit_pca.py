"""Fit the 256 -> 64 local-descriptor PCA projection.

    python -m omniswarm_torch.tools.fit_pca --desc descs.npy [--dim 64]
        [--out-components components_.csv] [--out-mean mean_.csv]
        [--out-npz superpoint.npz]

Counterpart of ``tools/fit_pca.py`` (the reference's pca.ipynb): takes a
``.npy`` of raw descriptors (N, 256), fits the projection with
``models.train_superpoint.fit_pca`` (a float64 SVD of the centred
descriptors on the host) and writes the reference's CSVs
(``components_.csv`` (dim, C), ``mean_.csv`` (1, C)) and/or adds
``pca_components`` and ``pca_mean`` to a SuperPoint ``.npz`` checkpoint in
place, dunder-prefixed (``__pca_components``) when the checkpoint is a
Flax-style one (``/`` in its keys). It runs on the host and takes no
device.
"""
from __future__ import annotations

import argparse

import numpy as np

from omniswarm_torch.models.train_superpoint import fit_pca


def add_to_npz(path: str, comps: np.ndarray, mean: np.ndarray) -> None:
    """Write the projection into the checkpoint at ``path`` (replacing any
    earlier one), with the ``__`` prefix of Flax-style checkpoints."""
    base = dict(np.load(path))
    pfx = "__" if any(k.count("/") for k in base) else ""
    base.pop("pca_components", None)
    base.pop("pca_mean", None)
    base[pfx + "pca_components"] = comps
    base[pfx + "pca_mean"] = mean
    np.savez(path, **base)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.fit_pca",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--desc", required=True, help=".npy of (N, C) descriptors")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--out-components")
    ap.add_argument("--out-mean")
    ap.add_argument("--out-npz", help="add pca_components/pca_mean to an "
                                      "existing SuperPoint npz checkpoint")
    args = ap.parse_args(argv)

    comps, mean, ratio = fit_pca(np.load(args.desc), args.dim)
    print(f"explained variance ratio (top {args.dim}): {ratio.sum():.3f}",
          flush=True)
    if args.out_components:
        np.savetxt(args.out_components, comps, delimiter=",")
    if args.out_mean:
        np.savetxt(args.out_mean, mean[None], delimiter=",")
    if args.out_npz:
        add_to_npz(args.out_npz, comps, mean)
        print(f"updated {args.out_npz}", flush=True)
    return comps, mean, ratio


if __name__ == "__main__":
    main()
