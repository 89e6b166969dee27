"""The repository's tools on the port, one module per ``tools/*.py`` under
the reference's file name, each run as ``python -m
omniswarm_torch.tools.<name>``:

- ``window_scale_sweep``: the solve at F = 1,024 ... 16,384 keyframes;
- ``bench_dense_loops``: the loop-dense window on PCG at 24/16/12/8 CG
  sweeps and on the Woodbury path;
- ``profile_fscale``, ``profile_f100``, ``profile_solver``,
  ``profile_fleet``: the solver's stage times and grids;
- ``replay_eval``: CSV flight logs through the estimator and the report;
- ``bus_spy``, ``network_tester``: the UDP multicast bus's spy and load
  tester;
- ``fit_pca``, ``eval_superpoint_textured``: the SuperPoint PCA fit and the
  textured matching eval.

Each takes the reference tool's flags and defaults plus ``--device``
(default ``cuda``; without CUDA it raises unless given ``cpu``). Each JSON
output keeps the reference's keys where they keep their meaning; the card
(``benchutil.card``) stands where the reference names its chip, and
``first_solve_s`` where it timed a compilation. ``--out`` never overwrites
one of the repository's pre-port result files.
"""
