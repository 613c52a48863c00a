"""``repro_torch.models.cnn`` against the reference ``repro.models.cnn`` on
the reference's ``cnn.init`` params (converted by
``convert.cnn_params_from_reference``) and RAVEN's 32 x 32 panels: query,
attribute logits and features at atol 1e-5 (fp32).  This catches XLA's
asymmetric ``SAME`` padding at stride 2 and the tanh form of gelu."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.data import raven as rr
from repro.models import cnn as rc
from repro_torch import convert
from repro_torch.device import disable_tf32
from repro_torch.models import cnn as tc

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def panels():
    b = rr.RavenDataset(rr.RavenConfig(batch_size=2, seed=4)).next_batch()
    return np.concatenate([b["images"], b["candidate_images"]], 1).reshape(
        -1, 32, 32)


@pytest.mark.parametrize("cfg_kw", [{}, {"channels": (8, 16), "head_hidden": 64,
                                         "vsa_dim": 256}])
def test_apply_equals_the_reference(panels, cfg_kw):
    disable_tf32()
    cfg_r, cfg_t = rc.CNNConfig(**cfg_kw), tc.CNNConfig(**cfg_kw)
    params = rc.init(jax.random.PRNGKey(1), cfg_r)
    model = convert.cnn_params_from_reference(jax.tree.map(np.asarray, params),
                                              device="cpu")
    assert tc.num_params(model) == rc.num_params(params)
    want = rc.apply(params, jnp.asarray(panels), cfg_r)
    got = tc.apply(model, torch.from_numpy(panels), cfg_t)
    for key in ("query", "features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0)
    assert len(got["attr_logits"]) == len(cfg_t.attr_sizes)
    for g, w in zip(got["attr_logits"], want["attr_logits"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_same_padding_is_asymmetric_at_stride_2():
    """32 -> 16 pads 0 before and 1 after, so the first output sums a full
    3 x 3 window of the input; symmetric padding=1 would not."""
    assert tc._same_pad(32, 3, 2) == (0, 1)
    assert tc._same_pad(7, 3, 2) == (1, 1)
    x = torch.ones(1, 1, 32, 32)
    w = torch.ones(1, 1, 3, 3)
    out = tc._conv(x, w, torch.zeros(1), stride=2)
    assert out.shape == (1, 1, 16, 16)
    assert float(out[0, 0, 0, 0]) == 9.0
    assert float(F.conv2d(x, w, padding=1, stride=2)[0, 0, 0, 0]) == 4.0


def test_init_is_seeded_and_scaled():
    cfg = tc.CNNConfig()
    a, b = tc.init(cfg, 3, device="cpu"), tc.init(cfg, 3, device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert a.conv0_w.shape == (32, 1, 3, 3)
    assert abs(float(a.conv2_w.std()) - (2.0 / (9 * 64)) ** 0.5) < 0.01
    assert tc.num_params(a) == rc.num_params(rc.init(jax.random.PRNGKey(0),
                                                     rc.CNNConfig()))
