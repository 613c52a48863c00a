"""The plain reference against the port at a small size on the CPU: the
same Philox normals, the same int8 books, the same sweeps (bit for bit in
one batch), the same abduction tail; and the control's precisions."""
import numpy as np
import pytest
import torch

from perfbench.tests.common import small_cell
from perfbench.bench import inputs, spec
from perfbench.reference import philox, quant
from perfbench.reference import nvsa as ref_nvsa
from perfbench.reference.factorizer import Factorizer
from perfbench.systems.factorization import factorizer_config

SEED = 2 ** 31 + 41


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_philox_copy_equals_the_ports_generator():
    from repro_torch.core import rng

    keys = torch.as_tensor(inputs.row_keys(SEED, 0, 32))
    sweep = torch.arange(32, dtype=torch.int32) * 37 % 100
    for tag, f, n in ((rng.SCORES, 4, 10), (rng.RESTART, 3, 1024),
                      (rng.PROJECTION, 1, 7)):
        assert torch.equal(philox.normal(keys, sweep, tag, f, n),
                           rng.normal(keys, sweep, tag, f, n))


def test_int8_books_equal_the_ports_quantisation():
    from repro_torch.core import factorizer as fz

    gen = inputs.device_generator(SEED, 1, "cpu")
    x = inputs.unitary_atoms(gen, (4, 10), 1024, 4, "cpu")
    assert torch.equal(quant.dequantized(x, "int8"),
                       fz.quantize_codebooks(x, "int8").dequantize())
    q4 = quant.dequantized(x, "int4")
    scale = x.abs().amax(-1, keepdim=True) / 7.0 + 1e-12
    assert ((q4 / scale).round().abs() <= 7).all()
    assert (q4 - x).abs().max() > (quant.dequantized(x, "int8") - x).abs().max()


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0],
                     dtype=torch.float32)
    assert quant.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
    a, b = torch.randn(8, 64), torch.randn(64, 5)
    got = quant.matmul(a, b, "tf32")
    assert 0 < (got - a @ b).abs().max() < 1e-2


@pytest.mark.parametrize("name", ["tab7-int8.closed-256",
                                  "nvsa-raven.serve-256"])
def test_reference_sweeps_equal_the_ports_in_one_batch(name):
    from repro_torch.core import factorizer as fz

    cell = small_cell(name)
    system = spec.load_module("systems", cell.config["system"]).System(
        cell.config, cell.traffic, SEED, torch.device("cpu"))
    cfg = factorizer_config(cell.config)
    books = (fz.quantize_codebooks(system.atoms, "int8")
             if cfg.codebook_fmt == "int8" else system.atoms)
    q = (system.queries if hasattr(system, "queries") else
         system.ctx.reshape(-1, cell.config["dim"]))[:12]
    keys = torch.as_tensor(inputs.row_keys(SEED, 0, 12))
    mask = None if cfg.codebook_fmt == "int8" else system.mask
    port = fz._factorize_batched(q, books, keys, cfg, mask)
    ref = Factorizer(quant.dequantized(system.atoms, cfg.codebook_fmt),
                     system.mask, cell.config).run(q, keys)
    np.testing.assert_array_equal(ref["indices"], port.indices.numpy())
    np.testing.assert_array_equal(ref["iterations"], port.iterations.numpy())
    np.testing.assert_array_equal(ref["converged"], port.converged.numpy())
    np.testing.assert_array_equal(ref["scores"], port.scores.numpy())


def test_reference_tail_equals_the_ports_abduction():
    from repro_torch.core import factorizer as fz
    from repro_torch.models import nvsa

    cell = small_cell("nvsa-raven.serve-256")
    system = spec.load_module("systems", "nvsa_abduction").System(
        cell.config, cell.traffic, SEED, torch.device("cpu"))
    cfg = system.nvsa_config()
    B = 6
    q = system.ctx[:B].reshape(B * 8, -1)
    keys = torch.as_tensor(inputs.row_keys(SEED, 0, B * 8))
    res = fz._factorize_batched(q, system.atoms, keys, cfg.factorizer,
                                system.mask)
    bel = nvsa.beliefs_from_scores(q, res.scores, system.mask, cfg)
    ans, sims = nvsa.abduce_answers(bel.reshape(B, 8, 3, -1), system.cand[:B],
                                    system.atoms, cfg)
    rbel = ref_nvsa.beliefs(q, res.scores, system.mask, cfg.belief_temp)
    torch.testing.assert_close(rbel, bel, rtol=0, atol=0)
    rans, rsims = ref_nvsa.answers(rbel.reshape(B, 8, 3, -1), system.cand[:B],
                                   system.atoms, system.sizes, 4)
    assert torch.equal(rans, ans)
    torch.testing.assert_close(rsims, sims, rtol=0, atol=1e-6)
    # the oracle queries decode: most answers right
    assert (ans.numpy() == system.truth[:B]).mean() >= 0.5
