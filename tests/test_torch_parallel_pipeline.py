"""The port's pipeline-parallel transition (``parallel/pipeline.py``) on
three CPU devices in one process against the JAX package's on three
virtual CPU devices: bit-equal latents for 1, 2 and 4 microbatches, the
probabilities within 1e-6, and the batch's divisibility."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.models.world_model import init_transition
from scmgan_tpu.parallel.pipeline import pipeline_transition as jax_pipeline
from scmgan_tpu_torch.models.world_model import transition
from scmgan_tpu_torch.parallel.mesh import tree_map
from scmgan_tpu_torch.parallel.pipeline import N_STAGES, pipeline_transition

B, HW, LATENT, ACTIONS, HIDDEN = 8, 16, 8, 4, 32
CPUS = [torch.device("cpu")] * N_STAGES
# the probabilities: f32 convs summed in other orders by the two frameworks
PROBS_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    """tests/test_pipeline.py's weights and inputs."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = init_transition(k1, LATENT, ACTIONS, hidden=HIDDEN)
    z = (jax.random.uniform(k2, (B, HW, HW, LATENT)) > 0.5).astype(jnp.float32)
    a = jax.nn.one_hot(jax.random.randint(k3, (B,), 0, ACTIONS), ACTIONS)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N_STAGES]), ("pipe",))
    port = (tree_map(lambda x: torch.from_numpy(np.asarray(x)), params),
            torch.from_numpy(np.asarray(z)), torch.from_numpy(np.asarray(a)))
    return params, z, a, mesh, port


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_matches_jax(setup, n_micro):
    params, z, a, mesh, (tp, tz, ta) = setup
    want = np.asarray(jax_pipeline(params, z, a, mesh, n_micro=n_micro))
    got = pipeline_transition(tp, tz, ta, CPUS, n_micro=n_micro)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the port's own one-device transition
    np.testing.assert_array_equal(got.numpy(), transition(tp, tz, ta, train=False).numpy())


def test_pipeline_probabilities_match_jax(setup):
    params, z, a, mesh, (tp, tz, ta) = setup
    want = np.asarray(jax_pipeline(params, z, a, mesh, n_micro=2, sample=False))
    got = pipeline_transition(tp, tz, ta, CPUS, n_micro=2, sample=False)
    assert got.shape == (B, HW, HW, LATENT)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROBS_ATOL)


def test_pipeline_refuses_an_indivisible_batch(setup):
    _, _, _, _, (tp, tz, ta) = setup
    with pytest.raises(ValueError, match="divide into 3 microbatches"):
        pipeline_transition(tp, tz, ta, CPUS, n_micro=3)
    with pytest.raises(ValueError, match="3 stages"):
        pipeline_transition(tp, tz, ta, CPUS[:2], n_micro=2)
