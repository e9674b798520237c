"""Checkpoint sanity check: load a saved model and reconstruct one frame.

Port of ``scmgan_tpu/analysis/sanity.py`` (the reference's
``visualize.py:30-65``, which loads the five .pth files and writes a single
reconstruction image).  The encoder runs in f32 with TF32 off; the decoder
is the serving kernel ``fused_decode``, which equals ``decode`` by
linearity (on the CPU its plain version).

Usage:
  python -m scmgan_tpu_torch.analysis.sanity --env pong --load-from <dir>
  python -m scmgan_tpu_torch.analysis.sanity --env pong --load-from <dir> --platform cpu
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch


def sanity_check(load_from: str, env: str = "pong", out_dir: str = ".",
                 latent_dim: int = 16, seed: int = 0, device="cuda",
                 frames: Optional[torch.Tensor] = None) -> str:
    """Writes ``sanity_reconstruction.png`` in ``out_dir`` (the third frame
    beside its reconstruction) and returns its path.  ``frames``: a
    (1, 3, H, W, C) window to reconstruct in place of one collected from
    the env's datasource seeded with ``seed``."""
    from scmgan_tpu_torch.analysis.video import save_image
    from scmgan_tpu_torch.data.datasource import allocate_datasource
    from scmgan_tpu_torch.models.world_model import encode, init_world_model
    from scmgan_tpu_torch.ops.kernels.fused_decoder import (
        fused_decode,
        pack_decoder_weights,
    )
    from scmgan_tpu_torch.train.checkpoint import load_model
    from scmgan_tpu_torch.utils.device import no_tf32

    ds = allocate_datasource(env, seed=seed, device=device)
    template = init_world_model(
        torch.Generator(device=ds.device).manual_seed(seed), latent_dim,
        ds.binary_input_channels, ds.scalar_output_channels,
        ds.conv_input_channels, ds.conv_output_channels, img_size=ds.spec.height)
    params = load_model(load_from, ds.device, template)

    if frames is None:
        frames, *_ = ds.collect(1, 3)
    frames = frames.to(ds.device, torch.float32)
    with torch.inference_mode(), no_tf32():
        z = encode(params.encoder, frames[:, :3])
        logits = fused_decode(pack_decoder_weights(params.decoder, latent_dim), z)
        recon = torch.sigmoid(logits.float())[0].cpu().numpy()
    actual = frames[0, 2].cpu().numpy()
    panel = np.concatenate([actual, recon], axis=1)
    path = os.path.join(out_dir, "sanity_reconstruction.png")
    save_image(panel, path, resize_to=(256, 512))
    print(f"Wrote {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="pong")
    ap.add_argument("--load-from", required=True)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--platform", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    from scmgan_tpu_torch.cli.main import platform_device

    return sanity_check(args.load_from, args.env, args.out_dir, args.latent_dim,
                        device=platform_device(args.platform))


if __name__ == "__main__":
    main()
