"""The port's batched PlaceDB query + insert against the JAX reference:
``query2_add_batch`` and ``query2_add_payload_batch`` over several batches,
with a ring that wraps, queries that must not see their own batch's
inserts, and the recency guard."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniswarm_torch.ops import placedb as tpdb
from omniswarm_tpu.ops import placedb as jpdb

torch.set_num_threads(1)
CAP, DIM, KB, P = 6, 16, 4, 5


def unit_rows(rng, n):
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def batches(rng):
    """Four batches of 3-4 queries; a repeated descriptor makes a query's
    own insert its best match if the batch could see itself."""
    out = []
    frame = 0
    for b in range(4):
        n = 3 if b % 2 else 4
        descs = unit_rows(rng, n)
        descs[-1] = descs[0]                      # duplicate in the batch
        metas = np.zeros((n, 4), np.int32)
        for i in range(n):
            frame += 1
            metas[i] = (i % 2, frame, 3 if i % 2 == 0 else 1, 1)
        add_sel = np.asarray([1, 2, 0, 1, 2, 1][:n], np.int32)
        qpacks = rng.normal(size=(n, KB, P)).astype(np.float16)
        out.append((descs, metas, add_sel, qpacks))
    return out


@pytest.mark.parametrize("payload", [False, True])
def test_batches_match_reference(payload, rng):
    ja, jb = jpdb.make_placedb(CAP, DIM), jpdb.make_placedb(CAP, DIM)
    ta = tpdb.make_placedb(CAP, DIM, "cpu")
    tb = tpdb.make_placedb(CAP, DIM, "cpu")
    jpa = jpb = jnp.zeros((CAP, KB, P), jnp.float16)
    tpa = torch.zeros((CAP, KB, P), dtype=torch.float16)
    tpb = torch.zeros((CAP, KB, P), dtype=torch.float16)
    # prefill a with entries of drone 0 (frames 0-4) so that the ring
    # wraps during the batches and the recency guard bites
    for f, d in enumerate(unit_rows(rng, 5)):
        ja = jpdb.add(ja, jnp.asarray(d), jnp.int32(0), jnp.int32(f))
        ta = tpdb.add(ta, torch.from_numpy(d), 0, f)
    for descs, metas, add_sel, qpacks in batches(rng):
        if payload:
            want = jpdb.query2_add_payload_batch(
                ja, jb, jpa, jpb, jnp.asarray(descs), jnp.asarray(metas),
                jnp.asarray(add_sel), jnp.asarray(qpacks), k=3)
            got = tpdb.query2_add_payload_batch(
                ta, tb, tpa, tpb, torch.from_numpy(descs),
                torch.from_numpy(metas.astype(np.int64)), add_sel,
                torch.from_numpy(qpacks), k=3)
            ja, jb, jpa, jpb = want[4:]
            ta, tb, tpa, tpb = got[4:]
            np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
            np.testing.assert_array_equal(tpb.numpy(), np.asarray(jpb))
        else:
            want = jpdb.query2_add_batch(
                ja, jb, jnp.asarray(descs), jnp.asarray(metas),
                jnp.asarray(add_sel), k=3)
            got = tpdb.query2_add_batch(
                ta, tb, torch.from_numpy(descs),
                torch.from_numpy(metas.astype(np.int64)), add_sel, k=3)
            ja, jb = want[4:]
            ta, tb = got[4:]
        for g, w in zip(got[:4:2], want[:4:2]):           # indices
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got[1:4:2], want[1:4:2]):         # similarities
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        # no query sees an insert of its own batch (similarity 1 to itself)
        assert float(got[1].max()) < 0.999 and float(got[3].max()) < 0.999
        for t, j in ((ta, ja), (tb, jb)):
            assert t.cursor == int(j.cursor)
            np.testing.assert_allclose(t.desc.numpy(), np.asarray(j.desc))
            np.testing.assert_array_equal(t.drone_id.numpy(),
                                          np.asarray(j.drone_id))
            np.testing.assert_array_equal(t.frame_id.numpy(),
                                          np.asarray(j.frame_id))
            np.testing.assert_array_equal(t.valid.numpy(),
                                          np.asarray(j.valid))
    assert ta.cursor > CAP                                # a wrapped
