"""The port's sharded train step on a 2 x 2 mesh (dp = 2 x tp = 2, four
spawned gloo processes) against the JAX package's on four virtual CPU
devices, with the helpers and tolerances of test_torch_parallel_step.py:
the step with every objective, each process's shards and Adam moments,
the spatial transition with H split over 'model', and
``process_batch_slice`` by 'data' coordinate.
"""

import pytest

from test_torch_parallel_step import (
    check_matches_jax,
    check_shards,
    check_spatial,
    run_meshes,
)

SHAPE = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_meshes(tmp_path_factory, (SHAPE,))


def test_sharded_step_matches_jax(runs):
    check_matches_jax(runs, SHAPE)


def test_shards_have_leaf_spec_shapes(runs):
    check_shards(runs, SHAPE)


def test_spatial_transition_matches_jax(runs):
    check_spatial(runs, SHAPE)


def test_process_batch_slice_on_2x2(runs):
    """32 rows: 16 a 'data' coordinate, the same for 'model' peers; 33
    rows raise JAX's error."""
    ranks = [r["slices"] for r in runs["port"][SHAPE]]
    for r in ranks:
        assert r["slice"] == (16, 16 * r["data"])
        assert r["error"] == "global batch 33 must divide over 2 processes"
    assert [r["slice"] for r in ranks] == [(16, 0), (16, 0), (16, 16), (16, 16)]
