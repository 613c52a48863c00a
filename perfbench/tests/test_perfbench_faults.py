"""``correct`` from whole runs of the harness on the CPU (its look for a
card skipped), at small slot counts and published widths: true for the
program as it is, false with the timed path broken underneath: a sweep
that returns its state unchanged, half of the batch left out of the
sweep, a decode or an answer altered where it is produced, restarts never
taken, the sweep's noise at another scale.  One chip, so no exchange
between chips to leave out."""
import dataclasses

import pytest
import torch

from perfbench.tests.common import small_cell
from perfbench.bench import harness

SEED = 2 ** 31 + 1234
CELLS = ["tab7-int8.closed-4096", "nvsa-raven.serve-256"]


def run(name: str) -> dict:
    return harness.run_cell(small_cell(name), SEED, 2.0, False, device="cpu",
                            patience_s=3.0)


def unchanged(rs):
    return rs._replace(sweep=lambda qs, s: s)


def half_left_out(rs):
    def sweep(qs, s):
        new = rs.sweep(qs, s)
        keep = torch.arange(qs.shape[0]) >= qs.shape[0] // 2
        return new._replace(**{
            f: torch.where(keep.reshape(-1, *[1] * (getattr(s, f).dim() - 1)),
                           getattr(s, f), getattr(new, f))
            for f in ("est", "iters", "done", "sim")})
    return rs._replace(sweep=sweep)


def altered_decode(rs):
    def decode(qs, s):
        res = rs.decode(qs, s)
        idx = res.indices.clone()
        idx[..., 0] = (idx[..., 0] + 1) % res.scores.shape[-1]
        return res._replace(indices=idx)
    return rs._replace(decode=decode)


def plant_config(monkeypatch, **change):
    """The program's sweep built under its configuration with ``change``."""
    from repro_torch.core import factorizer as fz

    real = fz.make_resonator
    monkeypatch.setattr(fz, "make_resonator", lambda cb, cfg, *a, **k: real(
        cb, dataclasses.replace(cfg, **change), *a, **k))


def plant(monkeypatch, wrap):
    from repro_torch.core import factorizer as fz

    real = fz.make_resonator
    monkeypatch.setattr(fz, "make_resonator",
                        lambda *a, **k: wrap(real(*a, **k)))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out])
def test_a_broken_sweep_is_not_correct(monkeypatch, name, fault):
    plant(monkeypatch, fault)
    res = run(name)
    assert not res["correct"]
    assert res["checks"]["unanswered"]["value"] > 0


def test_an_altered_decode_is_not_correct(monkeypatch):
    plant(monkeypatch, altered_decode)
    res = run("tab7-int8.closed-4096")
    assert not res["correct"]
    for name in ("score_gap", "wrong_decode_excess"):
        assert res["checks"][name]["value"] > res["checks"][name]["limit"]


@pytest.mark.parametrize("change", [dict(restart_every=0),
                                    dict(noise_std=0.15), dict(noise_std=0.6)],
                         ids=["restart_off", "noise_half", "noise_double"])
def test_a_changed_sweep_is_not_correct(monkeypatch, change):
    plant_config(monkeypatch, **change)
    res = harness.run_cell(small_cell("tab7-int8.closed-256"), SEED, 3.0,
                           False, device="cpu", patience_s=30.0)
    assert not res["correct"], res["checks"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from repro_torch.models import nvsa

    real = nvsa.abduce_answers

    def altered(*a, **k):
        answer, sims = real(*a, **k)
        return (answer + 1) % 8, sims

    monkeypatch.setattr(nvsa, "abduce_answers", altered)
    res = run("nvsa-raven.serve-256")
    assert not res["correct"]
    assert res["checks"]["tail_gap"]["value"] > res["checks"]["tail_gap"]["limit"]
