"""The port's paged ``ServeEngine`` bit for bit against the reference's, run
op by op.

Under ``jax.jit`` (how the reference's ``ServeEngine`` runs) XLA fuses
RoPE and computes its sin/cos differently from the same ops run one by one
(1.3e-5 apart at fp32), which moves the reference's own bf16 logits by up
to 2 ulps between its jitted and its op-by-op execution.  Run op by op
(``jax.disable_jit()``, the Pallas decode kernel interpreted), the
reference gives the port's numbers exactly: the same last-prefill logits,
the same decode logits and the same greedy streams, at three block sizes,
with the bf16 and the int8 KV pool.  (``tests/test_torch_paging.py``
holds the port against the jitted reference, up to near ties.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.launch.serve import ServeEngine as RServe
from repro.lm.paging import PagedConfig as RPaged
from repro.nn import transformer as RT
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch.serve import ServeEngine
from repro_torch.lm.paging import PagedConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg_r = ARCHS["llama3.2-3b"].smoke()
    params_r, _ = RT.init(jax.random.PRNGKey(0), cfg_r)
    cfg_t = registry.get("llama3.2-3b").smoke()
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    return cfg_r, params_r, cfg_t, model


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("bs,chunk", [(4, 3), (8, 4), (16, 8)])
def test_streams_bit_equal_to_the_reference_run_op_by_op(weights, kv, bs,
                                                         chunk):
    cfg_r, params_r, cfg_t, model = weights
    cfg_r = dataclasses.replace(cfg_r, kv_cache_dtype=kv)
    cfg_t = dataclasses.replace(cfg_t, kv_cache_dtype=kv)
    # max_len 16 holds the 9-token prompt and 3 steps; a short table keeps
    # the interpreted Pallas kernel's grid (rows x table width) small
    ref = RServe(cfg_r, params_r, 3, 16,
                 paged=RPaged(block_size=bs, prefill_chunk=chunk))
    eng = ServeEngine(cfg_t, model, 3, 16, device="cpu",
                      paged=PagedConfig(block_size=bs, prefill_chunk=chunk))
    logits = []
    inner = ref._decode_paged
    ref._decode_paged = lambda *a: logits.append(inner(*a)) or logits[-1]
    with jax.disable_jit():
        # a 1-token prompt (nothing to prefill), and off / at chunk bounds
        for s, n in enumerate((1, 5, 9)):
            p = np.asarray(jax.random.randint(jax.random.PRNGKey(s + 1),
                                              (n,), 0, cfg_r.vocab))
            lr, lp = ref.add_request(s, jnp.asarray(p)), eng.add_request(s, p)
            if lr is None:
                assert lp is None
            else:
                np.testing.assert_array_equal(lp.numpy(), np.asarray(lr))
        for _ in range(3):
            ref.step()
            eng.step()
            np.testing.assert_array_equal(
                eng.last_logits.numpy(), np.asarray(logits[-1][0][:, -1]))
    assert eng.generated == ref.generated
    assert eng.kv_bytes_touched == ref.kv_bytes_touched
