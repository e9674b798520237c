"""The port's ``world_model_loss`` against scmgan_tpu's for the options
with extra transition calls: latent overshooting and latent TD(lambda) (the
(B, S, H, W, L) slot buffer advanced as one B*S batch per step) and the two
counterfactual regularizers with 3-step roll-outs.  Same weights, batch,
replayed key schedule and tolerances as ``test_torch_port_train_loss.py``.
"""

import pytest

from test_torch_port_train_loss import CASES_CF, check_case, setup  # noqa: F401


@pytest.mark.parametrize("case", list(CASES_CF))
def test_loss_grads_and_bits_match_jax(setup, case, monkeypatch):  # noqa: F811
    check_case(setup, *CASES_CF[case], monkeypatch)
