"""One drone in a process of its own, over real UDP multicast.

Counterpart of ``tools/drone_process.py``. Each process runs one
``DroneNode``: it loads the shared scenario (the simulated flight and the
visual world's seed) from an ``.npz``, feeds its own measurements and a
keyframe every 2nd frame, exchanges keyframes, loop edges and PCM inlier
sets with the peer processes through a ``UdpMulticastBus``, solves once at
the end and writes its estimate and its final solve's poses to an
``.npz``.

    python -m omniswarm_torch.runtime.drone_process --scenario s.npz \\
        --drone-id 0 --out out0.npz [--port 17700] [--step-wall 0.15] \\
        [--device cuda|cpu]

The scenario holds ``gt``, ``vio`` (F, D, 4), ``ranges``, ``range_valid``
(F, D, D), ``times`` (F,) and ``world_seed``. The node runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", required=True)
    ap.add_argument("--drone-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--port", type=int, default=17700)
    ap.add_argument("--step-wall", type=float, default=0.15,
                    help="wall seconds per sim frame (lets UDP flow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from omniswarm_torch.config import FrontendParams, SolverParams
    from omniswarm_torch.core.device import resolve_device
    from omniswarm_torch.runtime.udp_transport import UdpMulticastBus
    from omniswarm_torch.sim.visual_world import VisualWorld
    from omniswarm_torch.swarm.node import DroneNode

    dev = resolve_device(args.device)
    raw = np.load(args.scenario)
    gt, vio = raw["gt"], raw["vio"]
    ranges, range_valid = raw["ranges"], raw["range_valid"]
    times = raw["times"]
    F, D = gt.shape[:2]
    me = args.drone_id

    world = VisualWorld(seed=int(raw["world_seed"]), n_landmarks=600,
                        extent=8.0)
    bus = UdpMulticastBus(port=args.port)
    fp = FrontendParams(max_db_size=512, min_loop_matches=12,
                        match_index_dist=5, netvlad_thres=0.5,
                        pnp_iterations=128)
    node = DroneNode(me, bus,
                     solver_params=SolverParams(
                         pcm_redundant=False, max_iterations=60,
                         init_z_movement=0.05),
                     frontend_params=fp, global_dim=world.global_dim,
                     seed=me, device=dev)

    for k in range(F):
        t = float(times[k])
        node.on_swarm_frame(t, {d: vio[k, d] for d in range(D)},
                            {(a, b): float(ranges[k, a, b])
                             for a in range(D) for b in range(D)
                             if a != b and range_valid[k, a, b]})
        if k % 2 == 0:
            node.on_local_keyframe(world.make_keyframe(
                me, k, gt[k, me], t, vio_pose=vio[k, me]), t)
        # let the datagrams travel between the processes
        deadline = time.time() + args.step_wall
        while time.time() < deadline:
            bus.step(t)
            node.step(t)
            time.sleep(0.01)

    out = node.solve(t=float(times[-1]))
    est = node.estimator
    np.savez(args.out,
             solved=np.asarray(bool(out.get("solved"))),
             cost=np.asarray(out.get("cost", np.nan)),
             estimate=(est.estimate if est.estimate is not None
                       else np.zeros((0,))),
             # the final solve's poses, whatever its cost
             final_poses=(est._last_padded_poses[:est._last_num_window]
                          if out.get("solved") else np.zeros((0,))),
             window_ids=np.asarray(est.window_ids),
             kf_times=np.asarray([kf.t for kf in est.window]),
             loops_found=np.asarray(node.loops_found),
             loops_received=np.asarray(node.loops_received))
    bus.close()
    print(f"drone {me}: solved={out.get('solved')} "
          f"cost={out.get('cost', float('nan')):.2f} "
          f"loops found/recv={node.loops_found}/{node.loops_received}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
