"""Collective traffic of the frame-sharded window solver per LM iteration,
and the predicted window size at which N cards beat one.

    python -m omniswarm_torch.tools.comm_model [--ndev 8] [--out PATH]
        [--device cuda|cpu]

Counterpart of ``tools/comm_model.py``, which compiles one LM iteration of
the JAX layout on a virtual 8-device mesh and sums the collectives of its
HLO. Here the same problems (5 drones x F = 256 / 512 / 1,024 frames, seed
2, a loop every 16 frames) run on ``--ndev`` gloo ranks on the CPU
(``parallel.launch.run_ranks``) and the ``Axis`` counters are read:

- ``lm_iteration``: what the port's LM loop (``lm_solve_bt_sharded``)
  exchanges per iteration, the counters of 3 iterations less those of 1,
  halved. It is ``COMM_MODEL.json``'s row plus ``NAMED_DIFFERENCE``, one
  all-reduce call and 4 bytes, the ``[cost | bad]`` psum (see
  ``DIFFERENCE``); ``expected_by_op`` adds it to a recorded row.
- the fleet layout (5 x 32 lanes, ``max_loops`` 64, one lane a rank),
  whose solve must exchange no data: only the final gather of the result.

The bytes do not depend on the hardware. The N-card time is a prediction,

    t_N = t_1 / N + sum(bytes) / bw + n_collectives * latency,

from the per-iteration time t_1 MEASURED on one card in the same run
(``lm_solve_bt`` on the same graph, ``function_tolerance`` 0, the median
of 3 solves after a warm one, over its iterations) and an ASSUMED link
bandwidth and latency band (default: NVIDIA's published NVLink 4 rate of
the H100 SXM, 900 GB/s both ways, 450 GB/s one way; 5-25 us a
collective). The card's machine has one card, so no N-card time is
measured. Runs on the card unless ``--device cpu``; ``--out`` refuses the
repository's artifacts (``COMM_MODEL.json`` among them).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

FRAMES = (256, 512, 1024)
DRONES = 5
SEED = 2
LOOP_EVERY = 16
FLEET = dict(drones=5, frames=32, max_loops=64, seed=20, max_iterations=5)
BW = 4.5e11          # assumed: H100 SXM NVLink 4, 900 GB/s both ways
LATENCY = (5e-6, 2.5e-5)        # assumed band, seconds a collective
TIMED_ITERS = 20
TIMED_REPS = 3
# COMM_MODEL.json and the repository's other artifacts
REFERENCE_OUTPUTS = ("*.json", "omniswarm_tpu")
# the Axis operations under the HLO names of the reference's accounting
HLO_OPS = {"psum": "all-reduce", "pmax": "all-reduce",
           "all_gather": "all-gather", "send_next": "collective-permute",
           "recv_from_next": "collective-permute"}
DIFFERENCE = (
    "lm_iteration has one all-reduce call and 4 bytes more than "
    "COMM_MODEL.json's row, whose unit (tools/comm_model.py:90-97) is one "
    "assembly, the reduced current cost and one damped step: XLA groups "
    "that cost (4 B) with the capacitance's psum. The port's LM loop "
    "decides accept on the reduced cost of the candidate poses, which "
    "exists only after their assembly, after the capacitance's psum, so it "
    "rides in a second psum, [cost | bad] (8 B), whose second element is "
    "the step's failure flag (the reference loop's pmax of bad)")
# lm_iteration less COMM_MODEL.json's row, by HLO op (see DIFFERENCE)
NAMED_DIFFERENCE = {"all-reduce": {"count": 1, "bytes": 4}}


def window_problem(F: int):
    """(graph with numpy leaves, f32 init, loops) of the reference's
    problem at F frames."""
    from omniswarm_torch import sim
    from omniswarm_torch.solver.dense import dense_graph_from_sim

    data = sim.generate(sim.SimParams(num_drones=DRONES, num_frames=F,
                                      seed=SEED, loop_every=LOOP_EVERY))
    return (dense_graph_from_sim(data), np.asarray(data.vio, np.float32),
            len(data.loops))


def fleet_problem(lanes: int):
    """``lanes`` same-shape per-drone problems (graphs, inits)."""
    from omniswarm_torch import sim
    from omniswarm_torch.solver.dense import dense_graph_from_sim

    graphs, inits = [], []
    for s in range(lanes):
        d = sim.generate(sim.SimParams(num_drones=FLEET["drones"],
                                       num_frames=FLEET["frames"],
                                       seed=FLEET["seed"] + s))
        graphs.append(dense_graph_from_sim(d, max_loops=FLEET["max_loops"]))
        inits.append(np.asarray(d.vio, np.float32))
    return graphs, inits


def rank_calls(frames, ndev: int) -> list:
    """The ``call_each`` list: per F the LM loop at 1 and 3 iterations,
    then the fleet."""
    win = "omniswarm_torch.parallel.sharded_window:lm_solve_bt_sharded"
    calls = []
    for F in frames:
        graph, init, _ = window_problem(F)
        calls += [(win, dict(graph=graph, poses0=init, max_iterations=n,
                             function_tolerance=0.0)) for n in (1, 3)]
    graphs, inits = fleet_problem(ndev)
    calls.append(("omniswarm_torch.parallel.swarm_batch:solve_fleet",
                  dict(graphs=graphs, inits=inits,
                       max_iterations=FLEET["max_iterations"])))
    return calls


def by_hlo_op(counts: dict) -> dict:
    """Axis counters (result labels dropped) summed under HLO names."""
    out = {}
    for key, v in counts.items():
        if "/" in key or not v["calls"]:
            continue
        row = out.setdefault(HLO_OPS[key], {"count": 0, "bytes": 0})
        row["count"] += v["calls"]
        row["bytes"] += v["bytes"]
    return out


def expected_by_op(recorded: dict) -> dict:
    """A ``COMM_MODEL.json`` row's ``by_op`` plus ``NAMED_DIFFERENCE``:
    what the port's LM iteration must exchange, call for call and byte
    for byte."""
    out = {op: dict(v) for op, v in recorded.items()}
    for op, extra in NAMED_DIFFERENCE.items():
        row = out.setdefault(op, {"count": 0, "bytes": 0})
        for f in ("count", "bytes"):
            row[f] += extra[f]
    return out


def totals(ops: dict) -> dict:
    return dict(collectives_per_iter=sum(v["count"] for v in ops.values()),
                collective_bytes_per_iter=sum(v["bytes"]
                                              for v in ops.values()))


def traffic(frames=FRAMES, ndev: int = 8, timeout_s: float = 900.0) -> dict:
    """The counters of ``rank_calls`` on ``ndev`` gloo CPU ranks: per F the
    LM iteration's, and the fleet's."""
    from omniswarm_torch.parallel.launch import call_each, run_ranks

    ranks = run_ranks(call_each, ndev, backend="gloo", device="cpu",
                      args=(rank_calls(frames, ndev),), timeout_s=timeout_s)
    for r in ranks[1:]:                  # the same collectives on every rank
        if [c["counts"] for c in r] != [c["counts"] for c in ranks[0]]:
            raise RuntimeError("the ranks ran different collectives")
    got = ranks[0]
    rows = []
    for k, F in enumerate(frames):
        one, three = got[2 * k:2 * k + 2]
        if (one["result"].iterations, three["result"].iterations) != (1, 3):
            raise RuntimeError(f"F={F}: the LM loop stopped early")
        a, b = one["counts"], three["counts"]
        per_iter = {key: {f: (b[key][f] - a.get(key, {f: 0})[f]) // 2
                          for f in b[key]} for key in b}
        _, _, loops = window_problem(F)
        lm_ops = by_hlo_op(per_iter)
        rows.append(dict(
            F=F, D=DRONES, loops=loops, woodbury_cols=4 * loops,
            lm_iteration=dict(by_op=lm_ops, axis_counters=per_iter,
                              **totals(lm_ops))))
    fleet = got[-1]["counts"]
    data = {k: v for k, v in fleet.items() if "/" not in k}
    return dict(ndev=ndev, frame_sharded=rows,
                fleet_layout_counters=fleet,
                fleet_layout_data_collectives=sum(v["calls"]
                                                  for v in data.values()),
                fleet_layout_zero_data_collectives=not data)


def world1_ms(frames, device, iters: int = TIMED_ITERS,
              reps: int = TIMED_REPS) -> dict:
    """{F: (ms an iteration, K1 launches an iteration)} of ``lm_solve_bt``
    on one card (its default linear path), synchronised on the host
    clock."""
    from omniswarm_torch.convert import dense_graph_to_torch
    from omniswarm_torch.solver.dense import lm_solve_bt
    from omniswarm_torch.solver.fused_level import fused_reduction_level

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    for F in frames:
        graph, init, _ = window_problem(F)
        graph = dense_graph_to_torch(graph, dev)
        init = torch.as_tensor(init, device=dev)
        lm_solve_bt(graph, init, device=dev, max_iterations=iters,
                    function_tolerance=0.0)
        ts, n = [], []
        k0 = fused_reduction_level.launches
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            r = lm_solve_bt(graph, init, device=dev, max_iterations=iters,
                            function_tolerance=0.0)
            sync()
            ts.append(time.perf_counter() - t0)
            n.append(int(r.iterations))
        out[F] = (statistics.median(ts) * 1e3 / n[0],
                  (fused_reduction_level.launches - k0) / sum(n))
    return out


def predict(comm: dict, t1: dict, card: str, *, bw: float = BW,
            latency=LATENCY) -> dict:
    """The reference's formula on the LM iteration's traffic; the
    crossover F from the largest window's per-frame time and traffic."""
    N = comm["ndev"]
    rows = []
    for row in comm["frame_sharded"]:
        F = row["F"]
        ms, k1 = t1[F]
        lm = row["lm_iteration"]
        comm_ms = [lm["collective_bytes_per_iter"] / bw * 1e3
                   + lm["collectives_per_iter"] * lat * 1e3
                   for lat in latency]
        tn = [ms / N + c for c in comm_ms]
        rows.append(dict(row, t1_ms_per_iter=ms, t1_k1_launches_per_iter=k1,
                         tN_ms_per_iter_pred=tn,
                         speedup_pred=[ms / tn[1], ms / tn[0]]))
    last = rows[-1]
    per_frame = last["t1_ms_per_iter"] / last["F"]
    lm = last["lm_iteration"]
    cross = [(lm["collective_bytes_per_iter"] / bw * 1e3
              + lm["collectives_per_iter"] * lat * 1e3)
             / (per_frame * (1 - 1 / N)) for lat in latency]
    return dict(
        description="Per-iteration collective traffic of the port's "
                    "frame-sharded window solver (Axis counters on gloo "
                    "CPU ranks) and a predicted N-card crossover",
        ndev=N,
        assumed=dict(bw_bytes_per_s=bw, latency_band_s=list(latency),
                     source="NVIDIA H100 SXM NVLink 4: 900 GB/s both ways "
                            "(one way used); latency band assumed"),
        measured=dict(card=card, t1="lm_solve_bt on the same graph, one "
                      "card, median of %d solves of %d iterations"
                      % (TIMED_REPS, TIMED_ITERS)),
        prediction_only="the N-card times are predicted: no N-card run",
        difference_from_comm_model_json=dict(by_op=NAMED_DIFFERENCE,
                                             why=DIFFERENCE),
        frame_sharded=rows,
        crossover_F_pred={f"lat_{lat * 1e6:g}us": c
                          for lat, c in zip(latency, cross)},
        **{k: v for k, v in comm.items()
           if k not in ("ndev", "frame_sharded")})


def model(frames=FRAMES, ndev: int = 8, device="cuda") -> dict:
    from omniswarm_torch.benchutil import card
    from omniswarm_torch.core.device import resolve_device

    dev = resolve_device(device)
    comm = traffic(frames, ndev)
    return predict(comm, world1_ms(frames, dev), card(dev))


def main(argv=None) -> dict:
    from omniswarm_torch.benchutil import refuse_reference_output
    from omniswarm_torch.core.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.comm_model",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.out:
        refuse_reference_output(ap, args.out, REFERENCE_OUTPUTS)
    result = model(ndev=args.ndev, device=args.device)
    for row in result["frame_sharded"]:
        lm = row["lm_iteration"]
        print(f"[comm-model] F={row['F']}: "
              f"{lm['collectives_per_iter']} collectives/iter, "
              f"{lm['collective_bytes_per_iter']} B/iter, "
              f"t1={row['t1_ms_per_iter']:.4f} ms, t{args.ndev} pred "
              f"{row['tN_ms_per_iter_pred']} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
