"""The solver of the port: factor graphs, the generic and dense LMs, the
block-tridiagonal path and K1's dispatcher."""
from omniswarm_torch.solver import factors, graph, gauss_newton  # noqa: F401
from omniswarm_torch.solver.gauss_newton import (  # noqa: F401
    SolveResult,
    lm_solve,
    lm_solve_multi_init,
    total_cost,
)
from omniswarm_torch.solver.graph import (  # noqa: F401
    FactorGraph,
    GraphBuilder,
    diag_sqrt_info,
    empty_graph,
    sqrt_info_from_cov4,
)
