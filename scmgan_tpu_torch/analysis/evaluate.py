"""Top-level evaluation entry point (reference evaluate(), main.py:315-322).

Port of ``scmgan_tpu/analysis/evaluate.py``: the prediction-MSE measurement,
then the forward-simulation video and the reconstruction videos.  All nets
run in eval mode (threshold latents).  The JAX package splits three keys
from ``PRNGKey(train_iter)``; the port draws each part's trajectories from
its own generator seeded from ``train_iter``.  The f32 parts (encoder,
reward predictor) run with TF32 off, as the JAX package computes them.
"""

from __future__ import annotations

import torch

from scmgan_tpu_torch.analysis.mse import measure_prediction_mse
from scmgan_tpu_torch.analysis.visualize import (
    visualize_forward_simulation,
    visualize_reconstruction,
)
from scmgan_tpu_torch.models.world_model import WorldModel
from scmgan_tpu_torch.utils.device import no_tf32


def evaluate(params: WorldModel, datasource, train_iter: int = 0,
             use_training_set: bool = False, out_dir: str = ".",
             make_videos: bool = True, eval_batch_size: int = 100,
             eval_timesteps: int = 100):
    """Returns ``measure_prediction_mse``'s curves (or None for a degenerate
    batch) after writing its artifacts and, with ``make_videos``, the
    videos."""
    print("Evaluating networks...")
    g1, g2, g3 = (torch.Generator(device=datasource.device).manual_seed(3 * train_iter + i)
                  for i in range(3))
    with no_tf32():
        results = measure_prediction_mse(
            params, datasource, train_iter=train_iter,
            batch_size=eval_batch_size, timesteps=eval_timesteps,
            use_training_set=use_training_set, out_dir=out_dir, generator=g1)
        if make_videos:
            visualize_forward_simulation(
                params, datasource, train_iter=train_iter, out_dir=out_dir,
                generator=g2)
            visualize_reconstruction(
                params, datasource, train_iter=train_iter, out_dir=out_dir,
                generator=g3)
    return results
