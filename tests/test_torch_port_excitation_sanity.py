"""The port's excitation-BPTT backtrack and checkpoint sanity check
(scmgan_tpu_torch.analysis.{excitation_bptt,sanity}) against scmgan_tpu's
on the CPU.

``visualize_bptt`` runs on gridworld_cf (16x16) from a start that fires
within a few steps, with the JAX package's per-step uniforms and actions
(its ``fold_in`` keys) injected: the same firing step, the reward within
1e-5, each step's mask |g| / (1e-3 + max|g|) within 1e-4 and the same
frames.  The JAX function re-runs the chain from every step (O(t^2) eager
steps); the port takes every step's gradient from one backward pass.
``sanity_check`` on boxes_cf with the JAX package's frames injected: the
frame exact, the reconstruction within the bf16 decoder's tolerance.
"""

import os

import jax
import numpy as np
import pytest
import torch

from scmgan_tpu.analysis import excitation_bptt as jexc
from scmgan_tpu.analysis import sanity as jsanity
from scmgan_tpu.analysis import video as jvideo
from scmgan_tpu.data import allocate_datasource as jallocate
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu_torch.analysis import excitation_bptt as texc
from scmgan_tpu_torch.analysis import sanity as tsanity
from scmgan_tpu_torch.analysis import video as tvideo
from scmgan_tpu_torch.train.checkpoint import load_model

REPO = os.path.join(os.path.dirname(__file__), "..")
GRID = os.path.join(REPO, "pretrained_models", "gridworld_cf")
BOXES = os.path.join(REPO, "pretrained_models", "boxes_cf")
MINIPONG = os.path.join(REPO, "pretrained_models", "minipong_cf")
# f32 on both sides, convs summed in another order.
REWARD_ATOL, MASK_ATOL, FRAME_ATOL = 1e-5, 1e-4, 1e-5
# The reconstruction through the bf16 decoder (the port's plain version on
# the CPU) against JAX's f32 decode: a logit moves by a few bf16 ulps,
# which moves sigmoid(logit) by at most max(s (1 - s) dL), under 1e-2.
RECON_ATOL = 1e-2


def _jax_model(model):
    return jwm.WorldModel(**{n: jax.tree.map(lambda t: t.numpy(), getattr(model, n))
                             for n in jwm.WorldModel._fields})


class JaxNoise(texc.BpttNoise):
    """The JAX package's draws: step t's uniforms from
    ``fold_in(PRNGKey(seed), t)`` (``jax.random.bernoulli`` compares such a
    uniform with p), its action from ``fold_in(PRNGKey(seed ^ 0x5EED), t)``."""

    def __init__(self, seed):
        self.seed = seed

    def uniforms(self, t, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), t)
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape))))

    def action(self, t, num_actions):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed ^ 0x5EED), t)
        return int(jax.random.randint(key, (), 0, num_actions))


class FrameRecorder:
    """A ``Video`` that keeps the frames it is handed."""

    def __init__(self, filename, framerate=10):
        self.filename, self.frames = filename, []

    def write_frame(self, frame, resize_to=None, caption="", **_):
        self.frames.append(np.array(frame))

    def finish(self):
        return self.filename


@pytest.fixture(scope="module")
def grid_models():
    model = load_model(GRID, device="cpu")
    return model, _jax_model(model)


# (policy, seed): starts of scripts/excitation_zoo.py's protocol (the
# datasource's frames under PRNGKey(100 + seed)) that fire within 3 steps
CASES = [("reference", 7), ("random", 2)]


@pytest.mark.parametrize("policy,seed", CASES)
def test_visualize_bptt_matches_jax(grid_models, policy, seed, monkeypatch, tmp_path):
    model, jax_model = grid_models
    obs, *_ = jallocate("gridworld", seed=0).collect(1, 3, key=jax.random.PRNGKey(100 + seed))
    z0 = jwm.encode(jax_model.encoder, obs[:, 0:3])

    jgrads, jrewards, videos = [], [], []
    jax_grad, jax_predict = jax.grad, jexc.predict_reward

    def recording_grad(f):
        def run(*a):
            g = jax_grad(f)(*a)
            jgrads.append(np.asarray(g))
            return g
        return run

    def recording_predict(params, z, visualize=False):
        out = jax_predict(params, z, visualize=visualize)
        if not isinstance(z, jax.core.Tracer):   # the forward roll, not a chain
            jrewards.append((np.asarray(z), float(np.sum(out[0]))))
        return out

    def recorder(*a, **k):
        videos.append(FrameRecorder(*a, **k))
        return videos[-1]

    monkeypatch.setattr(jexc.jax, "grad", recording_grad)
    monkeypatch.setattr(jexc, "predict_reward", recording_predict)
    monkeypatch.setattr(jexc, "Video", recorder)
    monkeypatch.setattr(texc, "Video", recorder)
    bts = []
    port_backtrack = texc.backtrack
    monkeypatch.setattr(texc, "backtrack", lambda *a, **k: bts.append(port_backtrack(*a, **k))
                        or bts[-1])

    want = jexc.visualize_bptt(jax_model, z0, 4, out_dir=str(tmp_path), seed=seed,
                               policy=policy, filename="jax.mp4")
    got = texc.visualize_bptt(model, torch.from_numpy(np.array(z0)), 4, out_dir=str(tmp_path),
                              seed=seed, policy=policy, filename="port.mp4",
                              noise=JaxNoise(seed))
    assert want is not None and got is not None
    bt = bts[0]
    t_hit = len(jgrads) - 1
    assert bt.t_hit == t_hit and 1 <= t_hit <= 3
    assert len(jrewards) == t_hit + 1
    for t, (jz, jr) in enumerate(jrewards):
        np.testing.assert_array_equal(bt.zs[t].numpy(), jz, err_msg=f"z at step {t}")
        np.testing.assert_allclose(bt.rewards[t], jr, rtol=0, atol=REWARD_ATOL)
    for t, jg in enumerate(jgrads):
        g = bt.grads[t].numpy()
        mask = np.abs(g) / (1e-3 + np.abs(g).max())
        jmask = np.abs(jg) / (1e-3 + np.abs(jg).max())
        np.testing.assert_allclose(mask, jmask, rtol=0, atol=MASK_ATOL, err_msg=f"step {t}")
        assert jmask.max() > 0.5
    jframes, tframes = videos[0].frames, videos[1].frames
    assert len(tframes) == len(jframes) == (t_hit + 1) * 5
    for t in range(t_hit + 1):   # the forward frames
        np.testing.assert_allclose(tframes[t], jframes[t], rtol=0, atol=FRAME_ATOL)


def test_visualize_bptt_default_noise_and_no_fire(grid_models, tmp_path, capsys):
    """Without injected noise the draws come from generators seeded from
    ``seed`` (the same run twice); a threshold no step reaches gives None."""
    model, jax_model = grid_models
    obs, *_ = jallocate("gridworld", seed=0).collect(1, 3, key=jax.random.PRNGKey(107))
    z0 = torch.from_numpy(np.array(jwm.encode(jax_model.encoder, obs[:, 0:3])))
    runs = [texc.backtrack(model, z0, 4, texc.BpttNoise(5, "cpu"), policy="random")
            for _ in range(2)]
    assert runs[0] is not None and runs[0].t_hit == runs[1].t_hit
    for a, b in zip(runs[0].grads, runs[1].grads):
        assert torch.equal(a, b)
    path = texc.visualize_bptt(model, z0, 4, out_dir=str(tmp_path), seed=5, policy="random",
                               filename="v.mp4")
    assert path is not None and os.path.exists(path)
    assert texc.visualize_bptt(model, z0, 4, steps=2, reward_threshold=1e9,
                               out_dir=str(tmp_path)) is None
    assert "No large expected reward" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown policy"):
        texc.backtrack(model, z0, 4, texc.BpttNoise(5, "cpu"), policy="greedy")


def test_sanity_check_matches_jax(monkeypatch, tmp_path):
    """boxes_cf (1 colour), the JAX package's three frames injected: the
    panel's frame half exact, its reconstruction within RECON_ATOL."""
    panels = []

    def recording(module):
        save = module.save_image

        def run(pixels, filename, resize_to=None):
            panels.append(np.array(pixels))
            return save(pixels, filename, resize_to=resize_to)
        return run

    monkeypatch.setattr(jvideo, "save_image", recording(jvideo))
    monkeypatch.setattr(tvideo, "save_image", recording(tvideo))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jsanity.sanity_check(BOXES, "boxes", str(jdir))
    frames, *_ = jallocate("boxes", seed=0).collect(1, 3)   # the same draw as above
    path = tsanity.sanity_check(BOXES, "boxes", str(tdir), device="cpu",
                                frames=torch.from_numpy(np.array(frames)))
    want, got = panels
    assert got.shape == want.shape == (64, 128, 1)
    np.testing.assert_array_equal(got[:, :64], want[:, :64])
    np.testing.assert_allclose(got[:, 64:], want[:, 64:], rtol=0, atol=RECON_ATOL)
    assert os.path.getsize(path) > 0


def test_sanity_main_platform(tmp_path):
    """``--platform cpu`` runs on the CPU; without it the card is asked for,
    and with no card the command raises."""
    path = tsanity.main(["--env", "minipong", "--load-from", MINIPONG,
                         "--out-dir", str(tmp_path), "--platform", "cpu"])
    assert path == os.path.join(str(tmp_path), "sanity_reconstruction.png")
    assert os.path.getsize(path) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsanity.main(["--env", "minipong", "--load-from", MINIPONG])
