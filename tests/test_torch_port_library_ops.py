"""The port's library ops against scmgan_tpu's on the CPU: the CSRN, the
CoordConv, the gaussian smoothing, ``random_eps`` / ``hypersphere_norm``,
``cov``, the profiling helpers, and dsprites (its renderer, and its loader
on a small npz the test writes).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.envs import dsprites as jds
from scmgan_tpu.ops import coordconv as jcc
from scmgan_tpu.ops import csrn as jcsrn
from scmgan_tpu.ops import smoothing as jsm
from scmgan_tpu.ops import stochastic as jst
from scmgan_tpu.utils import stats as jstats
from scmgan_tpu_torch.envs import dsprites as tds
from scmgan_tpu_torch.ops import coordconv as tcc
from scmgan_tpu_torch.ops import csrn as tcsrn
from scmgan_tpu_torch.ops import smoothing as tsm
from scmgan_tpu_torch.ops import stochastic as tst
from scmgan_tpu_torch.utils import profiling, stats as tstats

# f32 matmuls, convs and transcendentals summed or rounded in other orders
RTOL, ATOL = 1e-5, 1e-5
ULP_1 = float(np.spacing(np.float32(1.0)))   # one f32 ulp of values in [-1, 1)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("exploding", [False, True])
def test_csrn_matches_jax(exploding):
    """The four sweeps and the combine conv on JAX's weights, at a
    non-square size; init shapes and tree paths as JAX's."""
    c = 8
    jp = jcsrn.csrn_init(jax.random.PRNGKey(0), c, exploding_init=exploding)
    tp = tcsrn.csrn_init(torch.Generator().manual_seed(0), c, exploding_init=exploding)
    want_shapes = {k: v.shape for k, v in _leaves(jp).items()}
    assert {k: v.shape for k, v in _leaves(jax.tree.map(lambda t: t.numpy(), tp)).items()} \
        == want_shapes
    x = np.random.default_rng(0).standard_normal((2, 6, 5, c)).astype(np.float32)
    want = np.asarray(jcsrn.csrn_apply(jp, jnp.asarray(x)))
    got = tcsrn.csrn_apply(_t(jp), torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(1.0, np.abs(want).max()))


def test_gru_cell_and_conv1d_match_jax():
    rng = np.random.default_rng(1)
    g = jcsrn.gru_init(jax.random.PRNGKey(1), 4, 6, 0.5)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tcsrn.gru_cell(_t(g), torch.from_numpy(x), torch.from_numpy(h)).numpy(),
        np.asarray(jcsrn.gru_cell(g, jnp.asarray(x), jnp.asarray(h))), rtol=RTOL, atol=ATOL)
    k = jcsrn.conv1d_init(jax.random.PRNGKey(2), 4, 5, 0.3)
    k = {"w": k["w"], "b": jnp.arange(5, dtype=jnp.float32)}
    y = rng.standard_normal((2, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(tcsrn.conv1d(_t(k), torch.from_numpy(y)).numpy(),
                               np.asarray(jcsrn.conv1d(k, jnp.asarray(y))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(5, 7), (64, 64)])
def test_coordconv_matches_jax(hw):
    h, w = hw
    cx, cy = tcc.coord_channels(2, h, w)
    jx, jy = jcc.coord_channels(2, h, w)
    # torch.arange and jnp.arange round start + i * step differently: 1 ulp
    np.testing.assert_allclose(cx.numpy(), np.asarray(jx), rtol=0, atol=ULP_1)
    np.testing.assert_allclose(cy.numpy(), np.asarray(jy), rtol=0, atol=ULP_1)
    p = jcc.coordconv2d_init(jax.random.PRNGKey(3), 3, 4)
    x = np.random.default_rng(2).random((2, h, w, 3)).astype(np.float32)
    np.testing.assert_allclose(tcc.coordconv2d(_t(p), torch.from_numpy(x)).numpy(),
                               np.asarray(jcc.coordconv2d(p, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    assert tcc.coordconv2d_init(torch.Generator(), 3, 4)["w"].shape == p["w"].shape


@pytest.mark.parametrize("ksize,sigma", [(5, 1.0), (3, 0.5), (9, 2.5)])
def test_gaussian_smoothing_matches_jax(ksize, sigma):
    np.testing.assert_allclose(tsm.gaussian_kernel1d(ksize, sigma).numpy(),
                               np.asarray(jsm.gaussian_kernel1d(ksize, sigma)),
                               rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(3).random((2, 12, 10, 3)).astype(np.float32)
    got = tsm.gaussian_smooth2d(torch.from_numpy(x), ksize, sigma).numpy()
    want = np.asarray(jsm.gaussian_smooth2d(jnp.asarray(x), ksize, sigma))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_random_eps_and_hypersphere_norm_match_jax():
    key = jax.random.PRNGKey(4)
    shape = (3, 8, 6, 2)
    want = np.asarray(jst.random_eps(key, 0.3, *shape))
    # jax.random.bernoulli(key, p, shape) is uniform(key, shape) < p
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape, jnp.float32)))
    got = tst.random_eps(p=0.3, u=u).numpy()
    np.testing.assert_array_equal(got, want)
    drawn = tst.random_eps(torch.Generator().manual_seed(0), 0.3, 64, 16, 16, 3)
    assert drawn.shape == (64, 16, 16, 3) and drawn.dtype == torch.float32
    assert abs(float(drawn.mean()) - 0.3) < 0.02
    with pytest.raises(ValueError):
        tst.random_eps()
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(tst.hypersphere_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jst.hypersphere_norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,rowvar", [((7, 3), False), ((3, 7), True), ((9,), False),
                                          ((1, 6), False)])
def test_cov_matches_jax(shape, rowvar):
    m = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = np.asarray(jstats.cov(jnp.asarray(m), rowvar=rowvar))
    got = tstats.cov(torch.from_numpy(m), rowvar=rowvar).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        tstats.cov(torch.zeros(2, 2, 2))


def test_profiling_trace_sync_and_phase_timer(tmp_path):
    timer = profiling.PhaseTimer()
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "prof")) as logdir:
        for _ in range(2):
            with timer.phase("matmul", sync_tree={"a": [x]}):
                y = x @ x
    assert float(y[0, 0]) == 64.0
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert timer.counts["matmul"] == 2 and timer.totals["matmul"] > 0
    assert "matmul" in timer.summary()
    profiling.sync({"none": None})   # no tensor: nothing to wait for


def test_dsprites_renderer_matches_jax():
    rng = np.random.default_rng(6)
    for shape in range(3):
        idx = [int(rng.integers(6)), int(rng.integers(40)), int(rng.integers(32)),
               int(rng.integers(32))]
        np.testing.assert_array_equal(tds.render(*idx, shape=shape),
                                      jds.render(*idx, shape=shape))
    factors = rng.random((3, 4))
    np.testing.assert_array_equal(tds.simulator(factors), jds.simulator(factors))
    xb, tb = tds.get_batch(4, np.random.default_rng(7))
    xj, tj = jds.get_batch(4, np.random.default_rng(7))
    assert xb.shape == (4, 1, 64, 64)
    np.testing.assert_array_equal(xb, xj)
    np.testing.assert_array_equal(tb, tj)
    assert tds.normalize_factors([6, 40, 32, 32]) == [1.0, 1.0, 1.0, 1.0]


def test_dsprites_init_loads_an_npz(tmp_path, monkeypatch):
    """``init(path)`` on a small npz written here: images are read at the
    npz's index (scale-major, then orientation, x, y); a missing file
    switches back to the renderer.  Both modules' state is restored."""
    for mod in (tds, jds):
        monkeypatch.setattr(mod, "_imgs", mod._imgs)
        monkeypatch.setattr(mod, "_loaded_from_file", mod._loaded_from_file)
    imgs = np.random.default_rng(8).integers(0, 2, (64, 64, 64)).astype(np.uint8)
    path = tmp_path / "dsprites_small.npz"
    np.savez(path, imgs=imgs)
    tds.init(str(path))
    jds.init(str(path))
    assert tds._loaded_from_file
    for factors in ([0, 0, 0, 5], [0, 0, 1, 31], [0, 0, 1, 0]):
        idx = factors[3] + factors[2] * 32
        np.testing.assert_array_equal(tds.generate_image_discrete(factors), imgs[idx])
        np.testing.assert_array_equal(tds.generate_image_discrete(factors),
                                      jds.generate_image_discrete(factors))
    tds.init(str(tmp_path / "missing.npz"))
    assert not tds._loaded_from_file and tds._imgs is None
    np.testing.assert_array_equal(tds.generate_image_discrete([1, 2, 3, 4]),
                                  jds.render(1, 2, 3, 4))
