"""The serve executor's ``mesh`` (ROADMAP A6): each flush's lanes split
over the ranks of a ``DeviceMesh``'s first dimension, a front and its
followers (``engine/meshlink.py``).

One gloo group of four CPU processes is spawned for the file
(``torch_dist_worker.run_group("serve_mesh", 4)``, about 10 s). On the
(2,) and (4,) meshes the front (rank 0) serves the reference's sharded
serve requests (``TestShardedServe``, tests/test_serve.py:589-623): 16
ragged JLT requests and 12 KRR predicts with a replicated model; then a
cohort poisoned at the front's ``serve.flush`` site and one poisoned at a
follower's ``serve.mesh_block`` site; then it drains. Every follower
first tries a submit, then shuts down. Rank 0 also serves the same
requests on a one-rank executor.

Each lane is computed alone and does not depend on its cohort (ROADMAP
C15), so every mesh result must be ``torch.equal`` to the one-rank
executor's, which is stronger than the reference's own 1e-5; the results
are also held to the reference's ``T.apply`` and ``ml.krr_predict`` at
that test's tolerances. The group runs B1's f32 regime, which the
reference test's XLA route computes in (the default bf16x3 is held to
1e-4, ROADMAP C2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from libskylark_tpu import ml as rml, sketch as rsk
from libskylark_tpu.base.context import Context as RContext

MESHES = {"m2": 2, "m4": 4}
N_JLT, N_KRR = 16, 12


@pytest.fixture(scope="module")
def ranks():
    return W.run_group("serve_mesh", 4)


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_every_result_equals_the_one_rank_executor(ranks, mname):
    front = ranks[0]
    for i in range(N_JLT + N_KRR):
        np.testing.assert_array_equal(front[f"{mname}/{i}"],
                                      front[f"one/{i}"], err_msg=str(i))


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_ragged_jlt_matches_the_reference(ranks, mname):
    ctx = RContext(seed=11)
    for i, (n, A) in enumerate(W.serve_mesh_operands()):
        T = rsk.JLT(n, 16, ctx)
        ref = np.asarray(T.apply(jnp.asarray(A), rsk.COLUMNWISE))
        np.testing.assert_allclose(ranks[0][f"{mname}/{i}"], ref,
                                   rtol=1e-5, atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_replicated_krr_matches_the_reference(ranks, mname):
    X, _, queries = W.serve_mesh_krr()
    coef = jnp.asarray(ranks[0]["coef"])
    k = rml.Gaussian(4, sigma=1.5)
    for j, q in enumerate(queries):
        ref = np.asarray(rml.krr_predict(k, jnp.asarray(q), jnp.asarray(X),
                                         coef))
        np.testing.assert_allclose(ranks[0][f"{mname}/{N_JLT + j}"], ref,
                                   rtol=1e-4, atol=1e-5, err_msg=str(j))


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_capacities_round_up_to_the_rank_count(ranks, mname):
    n = MESHES[mname]
    caps = ranks[0][f"{mname}/caps"]
    assert len(caps) and all(c % n == 0 for c in caps)
    # each rank ran capacity / n lanes of every flush, the same on all
    lanes = ranks[0][f"{mname}/lanes"]
    assert sorted(set(int(c) // n for c in caps)) == sorted(lanes)
    for r in range(1, n):
        np.testing.assert_array_equal(ranks[r][f"{mname}/lanes"], lanes)
        # ndev, coordinate, flushes, failed flushes: one block of every
        # flush on every rank
        np.testing.assert_array_equal(
            ranks[r][f"{mname}/mesh"],
            [n, r, *ranks[0][f"{mname}/mesh"][2:]])


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_a_follower_submit_raises_naming_the_front(ranks, mname):
    for r in range(1, MESHES[mname]):
        msg = str(ranks[r][f"{mname}/follower_submit"])
        assert "mesh follower" in msg and "rank 0" in msg, msg


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("where", ["front_fault", "follower_fault"])
def test_a_poisoned_block_fails_only_its_request(ranks, mname, where):
    """A fault at the front's serve.flush, or in a follower's block, fails
    the front's attempt; bisection pins it to the poisoned request (a
    follower's failure arrives as MeshError), the others resolve to their
    one-rank bits, and the failures are counted."""
    front = ranks[0]
    errs = list(front[f"{mname}/{where}/errors"])
    want = "SketchError" if where == "front_fault" else "MeshError"
    assert errs == ["", want, "", ""]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(front[f"{mname}/{where}/ok/{i}"],
                                      front[f"one/{i}"])
    assert int(front[f"{mname}/flush_failures"]) >= 6
    # the follower fault's three failed attempts (cohort, half, single)
    assert int(front[f"{mname}/mesh"][3]) == 3


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_drain_and_shutdown_end_every_rank(ranks, mname):
    assert bool(ranks[0][f"{mname}/drained"])
    for r in range(1, MESHES[mname]):
        assert not bool(ranks[r][f"{mname}/follower_alive"])
