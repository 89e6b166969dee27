#!/usr/bin/env python3
"""Reference anchors for the training phase (12a) of ``chip_smoke.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/train_anchors.py

Runs the JAX package's trainers and metrics (the reference) on the CPU,
every one under ``jax.default_matmul_precision("highest")``:

- the bundled checkpoints' metrics: ``detection_metrics`` of
  ``superpoint_synthetic`` (32 images); ``matching_metrics`` of
  ``superpoint_photo_v2`` on 24 pairs each for the textured and flat rows of
  ``tools/eval_superpoint_textured.py`` (0.5 rad, zoom 0.85-1.2) and the
  default warp (0.3 rad, no zoom, line art); ``retrieval_metrics`` of
  ``netvlad_v2_revisit`` on the 96-way hard revisit tier of
  ``tests/test_train_netvlad.py``;
- 20-step loss histories of ``train_detector`` and ``train_descriptors``
  from ``superpoint_synthetic`` (seed 0, batch 8, 64 x 96, every step);
- ``train_netvlad`` at ``tools/train_netvlad_tool.py``'s defaults (v1
  encoder, 16 places a batch, pool 256, lr 3e-4, 96 x 160 views) for
  ``NETVLAD_STEPS`` steps, seeds 0-2: each run's last loss, the mean loss of
  its last ``FINAL_WINDOW`` steps and its easy 64-way recall@1.

Prints one JSON object to paste into ``chip_smoke.py``'s
``TRAIN_ANCHORS``; its wall time and peak resident memory go to stderr.
"""
from __future__ import annotations

import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "omniswarm_tpu" / "models" / "weights"
NETVLAD_STEPS = 200
FINAL_WINDOW = 20
SEEDS = (0, 1, 2)


def matching_rows(jsp):
    return {
        "textured": dict(max_rot=0.5, max_shift=12.0, scale=(0.85, 1.2),
                         render_fn=jsp.render_textured),
        "flat": dict(max_rot=0.5, max_shift=12.0, scale=(0.85, 1.2)),
        "easy": {},
    }


def superpoint_anchors() -> dict:
    from omniswarm_tpu.models import train_superpoint as jsp
    from omniswarm_tpu.models.superpoint import load_flax_npz

    syn = load_flax_npz(str(WEIGHTS / "superpoint_synthetic.npz"))["net"]
    photo = load_flax_npz(str(WEIGHTS / "superpoint_photo_v2.npz"))
    out = {"detection": jsp.detection_metrics(syn, n_eval=32)}
    out["matching"] = {}
    for name, kw in matching_rows(jsp).items():
        m = jsp.matching_metrics(photo, n_eval=24, **kw)
        m["correct"] = round(m["match_precision"] * m["matches"])
        out["matching"][name] = m
    print(f"superpoint metrics {time.perf_counter() - T0:.1f} s",
          file=sys.stderr, flush=True)
    kw = dict(steps=20, batch=8, h=64, w=96, seed=0, log_every=1,
              params=syn)
    _, out["detector_losses"] = jsp.train_detector(**kw)
    _, out["joint_losses"] = jsp.train_descriptors(**kw)
    print(f"superpoint histories {time.perf_counter() - T0:.1f} s",
          file=sys.stderr, flush=True)
    return out


def netvlad_anchors() -> dict:
    from omniswarm_tpu.models import train_netvlad as jnv
    from omniswarm_tpu.models.netvlad import load_netvlad_npz

    v2 = load_netvlad_npz(str(WEIGHTS / "netvlad_v2_revisit.npz"))
    hard = jnv.retrieval_metrics(v2, n_places=96, max_rot=0.5, noise=0.06,
                                 scale=(0.8, 1.25), revisit_offset=0.35,
                                 encoder_version=2)
    hard["correct"] = round(hard["recall_at_1"] * 96)
    runs = []
    for seed in SEEDS:
        params, hist = jnv.train_netvlad(steps=NETVLAD_STEPS, seed=seed,
                                         log_every=1)
        losses = [loss for _, loss in hist]
        easy = jnv.retrieval_metrics(params, encoder_version=1)
        runs.append({"seed": seed, "first_loss": losses[0],
                     "last_loss": losses[-1],
                     "final_loss": sum(losses[-FINAL_WINDOW:]) / FINAL_WINDOW,
                     "easy_recall": easy["recall_at_1"]})
        print(f"netvlad seed {seed}: {json.dumps(runs[-1])} "
              f"{time.perf_counter() - T0:.1f} s", file=sys.stderr,
              flush=True)
    return {"hard_revisit_96": hard, "steps": NETVLAD_STEPS,
            "final_window": FINAL_WINDOW, "runs": runs}


def main() -> int:
    import jax

    with jax.default_matmul_precision("highest"):
        out = {"superpoint": superpoint_anchors(),
               "netvlad": netvlad_anchors()}
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"train_anchors: {time.perf_counter() - T0:.1f} s, peak RSS "
          f"{peak:.2f} GB", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


T0 = time.perf_counter()

if __name__ == "__main__":
    sys.exit(main())
