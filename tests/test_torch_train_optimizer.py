"""``repro_torch.train.optimizer`` against ``repro.train.optimizer``.

Ports of the reference's oracles (``tests/test_train_infra.py``:
``test_optimizers_converge``, ``test_schedules``, ``test_grad_clip``), then
parity: the same initial params and the same 20 gradients (numpy, seeded)
through the reference's jitted ``opt.update`` and the port's ``step()``.

Tolerances:
  * fp32 params: rtol 1e-5, atol 1e-6.  Params are O(1); XLA contracts
    ``p - lr u`` into one FMA where torch rounds twice, so elements differ by
    an ulp or two of an O(1) term (2.4e-7 to 4.8e-7 observed), which rtol
    alone cannot hold for elements near zero.
  * bf16 moments: within one bf16 ulp (2^-7 relative) of the reference's;
    equal bits observed.
  * schedules: within 2 fp32 ulps at every step of 0..total.  XLA's fp32
    cos is not correctly rounded; the port rounds cos once from float64
    (13 of 4001 steps off, by at most 2 ulps, observed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ro
from repro_torch.train import optimizer as to

STEPS = 20
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The reference's oracles -----------------------------------------------------

def _toy_batch(step: int) -> dict:
    x = np.random.default_rng(step).standard_normal((16, 8)).astype(np.float32)
    x = torch.from_numpy(x)
    return {"x": x, "y": x @ torch.arange(8.0).reshape(8, 1)}


def _toy_loss(w, batch):
    return torch.mean((batch["x"] @ w - batch["y"]) ** 2)


@pytest.mark.parametrize("make_opt", [
    lambda p: to.sgd(p, 0.05), lambda p: to.adamw(p, 0.05),
    lambda p: to.adafactor(p, 0.3)], ids=["sgd", "adamw", "adafactor"])
def test_optimizers_converge(make_opt):
    w = torch.zeros((8, 1), requires_grad=True)
    opt = make_opt([w])
    losses = []
    for step in range(501):
        loss = _toy_loss(w, _toy_batch(step))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] / 50  # converging hard
    assert int(opt.state[w]["step"]) == 501


def test_schedules():
    wsd = to.wsd_schedule(1.0, warmup=10, total=100, decay_frac=0.2)
    assert wsd(5) == pytest.approx(0.5)
    assert wsd(50) == pytest.approx(1.0)  # stable plateau
    assert wsd(99) < 0.3  # decaying
    cos = to.cosine_schedule(1.0, warmup=10, total=100)
    assert cos(100) == pytest.approx(0.1, abs=1e-3)


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = to.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                  rel=1e-4)
    small = [torch.full((4,), 0.1), None]
    _, norm = to.clip_by_global_norm(small, 1.0)  # below the limit: unscaled
    assert float(norm) == pytest.approx(0.2)
    assert torch.equal(small[0], torch.full((4,), 0.1))


def test_grad_clip_matches_the_reference():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((64, 32)).astype(np.float32),
         "b": rng.standard_normal((32,)).astype(np.float32)}
    want, norm_r = ro.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    got, norm = to.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in g.items()}, 1.0)
    assert float(norm) == pytest.approx(float(norm_r), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)


# Parity with the reference's update rules -----------------------------------

def _parity(make_r, make_t, shapes: dict, bf16_moments=()):
    """Run both optimizers over STEPS seeded gradients; hold the params
    after every step and the named bf16 moments at the end."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (0.1 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(STEPS)]
    opt_r = make_r()
    params_r = {k: jnp.asarray(v) for k, v in p0.items()}
    state_r = opt_r.init(params_r)
    update = jax.jit(opt_r.update)
    names = sorted(shapes)
    params_t = {k: torch.tensor(p0[k], requires_grad=True) for k in names}
    opt_t = make_t([params_t[k] for k in names])
    for g in grads:
        params_r, state_r = update({k: jnp.asarray(v) for k, v in g.items()},
                                   state_r, params_r)
        for k in names:
            params_t[k].grad = torch.from_numpy(g[k].copy())
        opt_t.step()
        for k in names:
            np.testing.assert_allclose(params_t[k].detach().numpy(),
                                       np.asarray(params_r[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    for k in names:
        assert int(opt_t.state[params_t[k]]["step"]) == int(state_r["step"])
        for slot in bf16_moments:
            got = opt_t.state[params_t[k]][slot]
            assert got.dtype == torch.bfloat16
            got = got.float().numpy()
            want = np.asarray(state_r[slot][k].astype(jnp.float32))
            assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), \
                (k, slot)
    return opt_t, params_t


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
SHAPES = {"w": (64, 32), "b": (32,)}


@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_sgd_matches_the_reference(dtypes):
    r_dt, t_dt = dtypes
    _parity(lambda: ro.sgd(0.05, state_dtype=r_dt),
            lambda p: to.sgd(p, 0.05, state_dtype=t_dt), SHAPES,
            ("mu",) if t_dt == torch.bfloat16 else ())


@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_the_reference(dtypes, schedule):
    r_dt, t_dt = dtypes
    lr_r = 1e-2 if schedule == "constant" else ro.cosine_schedule(1e-2, 5,
                                                                  STEPS)
    lr_t = 1e-2 if schedule == "constant" else to.cosine_schedule(1e-2, 5,
                                                                  STEPS)
    _parity(lambda: ro.adamw(lr_r, weight_decay=0.01, state_dtype=r_dt),
            lambda p: to.adamw(p, lr_t, weight_decay=0.01, state_dtype=t_dt),
            SHAPES, ("m", "v") if t_dt == torch.bfloat16 else ())


def test_adafactor_matches_the_reference():
    opt, params = _parity(lambda: ro.adafactor(1e-2),
                          lambda p: to.adafactor(p, 1e-2),
                          {"w": (256, 128), "b": (128,)})
    w_state, b_state = opt.state[params["w"]], opt.state[params["b"]]
    assert w_state["vr"].shape == (256,) and w_state["vc"].shape == (128,)
    assert "v" not in w_state and b_state["v"].shape == (128,)
    assert to.Adafactor.factored((256, 128), 128)
    assert not to.Adafactor.factored((256, 127), 128)


@pytest.mark.parametrize("kind, args", [
    ("cosine", (3e-3, 100, 4000)), ("cosine", (1.0, 10, 100)),
    ("cosine", (0.5, 0, 37)), ("wsd", (1.0, 10, 100, 0.2)),
    ("wsd", (3e-3, 50, 1000))])
def test_schedules_match_the_reference_at_every_step(kind, args):
    make_r = getattr(ro, f"{kind}_schedule")
    make_t = getattr(to, f"{kind}_schedule")
    total = args[2]
    steps = jnp.arange(total + 1, dtype=jnp.int32)
    want = np.asarray(jax.vmap(make_r(*args))(steps), np.float32)
    got = np.array([make_t(*args)(s) for s in range(total + 1)], np.float32)
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 2, (int(ulps.argmax()), got[ulps.argmax()],
                             want[ulps.argmax()])


def test_lr_schedule_is_called_with_the_one_based_step():
    seen = []
    w = torch.zeros(3, requires_grad=True)
    opt = to.adamw([w], lambda s: seen.append(s) or 0.1)
    for _ in range(3):
        w.grad = torch.ones(3)
        opt.step()
    assert seen == [1, 2, 3]
