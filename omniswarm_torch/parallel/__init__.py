"""The multi-device layouts on ``torch.distributed`` (the reference's
``omniswarm_tpu/parallel``): the factor-sharded LM (``sharded_solver``),
the frame-sharded window (``sharded_window``, ``bt_spike``) and the fleet
lanes (``swarm_batch``), over an ``Axis`` (``collectives``) that
``launch.run_ranks`` hands to every rank."""
from omniswarm_torch.parallel.collectives import Axis  # noqa: F401
from omniswarm_torch.parallel.launch import run_ranks  # noqa: F401
from omniswarm_torch.parallel.sharded_solver import (  # noqa: F401
    graph_in_specs,
    graph_shard,
    make_mesh,
    shard_graph_factors,
    sharded_lm_solve,
)
