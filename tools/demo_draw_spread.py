#!/usr/bin/env python3
"""How far the image demo's result moves with RANSAC's random draws, on the
card.

    python3 tools/demo_draw_spread.py [--streams 8]

Runs ``omniswarm_torch.demo_entry.run_image_demo`` (5 drones x 30 frames,
the views rendered once) under several draw streams: stream s adds
``s << 20`` to every detector tick's seed, so stream 0 is
``image_demo_entry``'s own run and the others draw other Gumbel noise for
the same keyframes. Nothing else changes (the estimators' seeds, the bus,
the keyframes). Prints one JSON line per stream (recall, precision before
and after PCM, unique loops, per-drone cost and relative ATE, the loop
keys that differ from ``chip_smoke.DEMO_ANCHORS`` and from stream 0), then
a summary line: each drone's cost range over the streams beside the JAX
package's anchor, and the range of the key differences. A gap between the
card's run and the anchors that lies within the spread between two of the
port's own streams is the draws' doing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def shifted_kit(kit, shift: int):
    """The kit with every node's detector drawing tick noise for its seed
    plus ``shift``."""
    class Node(kit.DroneNode):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            draw = self.detector.tick_noise
            self.detector.tick_noise = (
                lambda seed, *shape: draw(seed + shift, *shape))
    return kit._replace(DroneNode=Node)


def key_diff(a: list, b: list) -> int:
    return len({tuple(k) for k in a} ^ {tuple(k) for k in b})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args()

    from chip_smoke import DEMO_ANCHORS
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.demo_entry import port_kit, run_image_demo
    from omniswarm_torch.frontend_entry import prepare

    want = DEMO_ANCHORS["image"]
    kit = port_kit(resolve_device("cuda"))
    prep = prepare()
    runs = []
    for s in range(args.streams):
        t0 = time.perf_counter()
        res = run_image_demo(shifted_kit(kit, s << 20), prep)
        row = {k: res[k] for k in ("loop_recall", "loop_precision",
                                   "loop_precision_post_pcm",
                                   "loops_unique", "all_solved")}
        row.update(
            stream=s, seconds=time.perf_counter() - t0,
            keys_vs_anchor=key_diff(res["loop_keys"], want["loop_keys"]),
            keys_vs_stream0=(key_diff(res["loop_keys"],
                                      runs[0]["loop_keys"]) if runs else 0),
            cost=[d.get("cost") for d in res["per_drone"]],
            relative_ate_cm=[d.get("relative_ate_cm")
                             for d in res["per_drone"]])
        runs.append(res)
        print("stream", json.dumps(row), flush=True)
    costs = [[d.get("cost") for d in r["per_drone"]] for r in runs]
    pairs = [key_diff(a["loop_keys"], b["loop_keys"])
             for i, a in enumerate(runs) for b in runs[i + 1:]]
    print("spread", json.dumps({
        "streams": len(runs),
        "cost_min": [min(c) for c in zip(*costs)],
        "cost_max": [max(c) for c in zip(*costs)],
        "anchor_cost": [d["cost"] for d in want["per_drone"]],
        "keys_vs_anchor": [key_diff(r["loop_keys"], want["loop_keys"])
                           for r in runs],
        "keys_between_streams_min": min(pairs, default=None),
        "keys_between_streams_max": max(pairs, default=None),
        "recall": [r["loop_recall"] for r in runs],
        "anchor_recall": want["loop_recall"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
