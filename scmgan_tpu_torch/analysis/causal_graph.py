"""Causal-graph extraction by counterfactual latent perturbation.

Port of ``scmgan_tpu/analysis/causal_graph.py``, protocol parity with the
reference (main.py:512-586, causal_graph.py:45-80): sample a transition two
predicted steps deep, zero each latent factor in turn, measure the squared
deviation it causes in every destination factor, normalize each run's
matrix to its own maximum, then take the maximum over the runs; render the
adjacency matrix and a circular digraph whose edge alphas are the weights.
All ``latent_dim`` counterfactuals of a run are one batch.

The transitions here run on the plain f32 route (``transition`` in eval
mode, TF32 off), never on the bf16 kernel: an edge weight is a maximum over
batch and pixels of squared differences of binary latents, so one bit that
flips near p = 0.5 saturates an edge to 1, and the JAX package computes it
in f32.  The JSON is always written; the matrix PNG needs PIL and the graph
matplotlib and networkx, and each is left out where its package does not
import.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from scmgan_tpu_torch.models.world_model import WorldModel, encode, transition
from scmgan_tpu_torch.utils.device import no_tf32


@torch.inference_mode()
def _causal_edge_weights(params: WorldModel, src_z, onehot_a):
    """(latent_dim, latent_dim) edge weights and mean deviations of one
    batch.  src_z: (B, H, W, L); weight[i, j] = max over batch and pixels of
    the squared deviation of factor j when factor i is zeroed (reference
    main.py:554-586); the mean deviation is the non-saturating diagnostic."""
    b, h, w, latent = src_z.shape
    with no_tf32():
        dst_z = transition(params.transition, src_z, onehot_a, train=False)
        keep = 1.0 - torch.eye(latent, dtype=src_z.dtype, device=src_z.device)
        perturbed = src_z[None] * keep[:, None, None, None, :]    # (L, B, H, W, L)
        cf = transition(params.transition, perturbed.reshape(latent * b, h, w, latent),
                        onehot_a.repeat(latent, 1), train=False)
    diff = (dst_z[None] - cf.reshape(latent, b, h, w, latent)) ** 2
    return diff.amax(dim=(1, 2, 3)), diff.mean(dim=(1, 2, 3))


@torch.inference_mode()
def sample_transition(params: WorldModel, datasource, batch_size: int = 32,
                      generator: Optional[torch.Generator] = None):
    """Encode t = 0..2, advance two predicted steps; return (src_z, onehot_a)
    (reference sample_transition, main.py:534-551)."""
    obs, rewards, dones, actions = datasource.collect(batch_size, 5, generator=generator)
    num_actions = datasource.binary_input_channels
    oh = lambda t: F.one_hot(actions[:, t].long(), num_actions).to(obs.dtype)  # noqa: E731
    with no_tf32():
        z = encode(params.encoder, obs[:, 0:3])
        z = transition(params.transition, z, oh(2), train=False)
        src_z = transition(params.transition, z, oh(3), train=False)
    return src_z, oh(4)


def compute_causal_graph(params: WorldModel, datasource, train_iter: int = 0,
                         runs: int = 10, out_dir: str = ".",
                         generator: Optional[torch.Generator] = None,
                         make_images: bool = True) -> np.ndarray:
    """Normalized causal adjacency, max over ``runs`` batches (reference
    compute_causal_graph, main.py:512-531).  Each run's matrix is normalized
    to its own max BEFORE the max over runs, the reference's order
    (main.py:584-586, then main.py:519).  The batches come from
    ``generator`` (default: seeded with ``train_iter`` on the datasource's
    device).  Writes causal_matrix_iter_*.json (``max``, ``mean_deviation``,
    ``runs``) and, where the packages import, the PNGs."""
    if generator is None:
        generator = torch.Generator(device=datasource.device).manual_seed(train_iter)
    weights_runs, mean_runs = [], []
    for _ in range(runs):
        src_z, onehot_a = sample_transition(params, datasource, generator=generator)
        w_i, m_i = (x.cpu().numpy() for x in _causal_edge_weights(params, src_z, onehot_a))
        weights_runs.append(w_i / max(w_i.max(), 1e-12))
        mean_runs.append(m_i)
    w = np.max(weights_runs, axis=0)

    print("Causal Graph Edge Weights")
    print(f"Latent Factor -> Latent Factor dim={w.shape[0]}")
    for row in w:
        print("\t".join(f"{v:.03f}" for v in row))

    # with binary eval-mode latents the max saturates every edge that flips
    # a single pixel anywhere; the mean deviation keeps the edges' order
    m = np.mean(mean_runs, axis=0)
    m = m / max(m.max(), 1e-12)
    print("Mean-deviation diagnostic (non-saturating, normalized)")
    for row in m:
        print("\t".join(f"{v:.03f}" for v in row))

    if make_images:
        with open(os.path.join(out_dir, f"causal_matrix_iter_{train_iter:06d}.json"),
                  "w") as fp:
            json.dump({"max": w.tolist(), "mean_deviation": m.tolist(), "runs": runs},
                      fp, indent=2)
        try:
            from PIL import Image
        except ImportError:
            return w
        from scmgan_tpu_torch.analysis.video import save_image

        save_image(w, os.path.join(out_dir, f"causal_matrix_iter_{train_iter:06d}.png"),
                   resize_to=(256, 256))
        img = render_causal_graph(w)
        if img is not None:
            Image.fromarray(img).save(os.path.join(
                out_dir, f"causal_graph_iter_{train_iter:06d}.png"))
            save_image(m, os.path.join(
                out_dir, f"causal_matrix_mean_iter_{train_iter:06d}.png"),
                resize_to=(256, 256))
            img_m = render_causal_graph(m)
            if img_m is not None:
                Image.fromarray(img_m).save(os.path.join(
                    out_dir, f"causal_graph_mean_iter_{train_iter:06d}.png"))
    return w


def render_causal_graph(scm: np.ndarray) -> Optional[np.ndarray]:
    """Circular-layout digraph with edge alpha = causal weight (reference
    causal_graph.py:45-80).  Returns RGB pixels, or None where networkx or
    matplotlib does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import networkx as nx
    except Exception:
        return None

    rows, cols = scm.shape
    adjacency = np.zeros((rows, rows))
    adjacency[:, :cols] = scm
    edge_alphas = adjacency.flatten()

    G = nx.MultiDiGraph(np.ones(adjacency.shape))
    pos = nx.layout.circular_layout(G)
    fig = plt.figure(figsize=(6, 6))
    nx.draw_networkx_nodes(G, pos, node_size=40, node_color="blue")
    edges = nx.draw_networkx_edges(
        G, pos, node_size=40, arrowstyle="->", arrowsize=20, width=2)
    labels = [f"$z_{{{i}}}$" for i in range(cols)] + [
        f"$a_{{{i}}}$" for i in range(rows - cols)]
    label_pos = {k: (v[0], v[1] + 0.1) for k, v in pos.items()}
    nx.draw_networkx_labels(G, label_pos,
                            {i: labels[i] for i in range(len(labels))},
                            font_size=16)
    if edges is not None:
        for i, e in enumerate(edges):
            e.set_alpha(float(np.clip(edge_alphas[i], 0, 1)))
    plt.gca().set_axis_off()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return buf
