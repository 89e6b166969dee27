"""Inputs of the K2 and K3 tests, shared by the card tests
(tests/test_torch_kernels_card.py) and the JAX oracle tests
(tests/test_torch_frontend_kernels.py). Imports no JAX."""
import numpy as np

# edge cases of the window: NaN cells, r = 0, a map smaller than its window,
# the largest radius with NaN
NMS_EDGE_CASES = [((2, 40, 64), 4, "nan"), ((2, 33, 65), 0, "random"),
                  ((1, 7, 5), 4, "random"), ((1, 20, 37), 16, "nan")]


def heat_map(rng, B, H, W, kind):
    """u**8 heat; ``plateau`` plants flat maxima and peaks on corners and
    edges, ``nan`` NaN inside, on a corner, on an edge and at 3 random
    cells of each map."""
    h = (rng.uniform(size=(B, H, W)) ** 8).astype(np.float32)
    if kind == "plateau":
        h[:, 4:20, 8:30] = 0.5                    # one flat maximum region
        h[:, 30:33, 40:43] = 0.25                 # a flat peak
        h[:, 0, 0] = 1.0                          # corners and edges
        h[:, -1, -1] = 1.0
        h[:, -1, 5] = 0.75
    elif kind == "nan":
        B, H, W = h.shape
        h[:, H // 2, W // 3] = np.nan             # inside, a corner and
        h[:, 0, W - 1] = np.nan                   # an edge: every window
        h[:, H - 1, W // 2] = np.nan              # that holds one gives 0
        h[:, rng.integers(0, H, 3), rng.integers(0, W, 3)] = np.nan
    return h


def unit_rows(rng, N, D):
    db = rng.normal(size=(N, D)).astype(np.float32)
    return db / np.linalg.norm(db, axis=1, keepdims=True)
