"""The port's counter-based generator (``repro_torch.core.rng``).

Philox-4x32-10 is checked against the published known-answer vectors of
Random123 and against a plain Python-integer version of the same rounds;
the normals are checked for what the factorizer relies on: a pure function
of (key, sweep, factor, tag, element), the same whatever the row's slot or
batch, different when any of those changes, with standard-normal moments
(each within 5 sigma / sqrt(n) of its expected value).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import factorizer as fz
from repro_torch.core import rng

M32 = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32, 10 rounds: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _philox_int(ctr, key):
    """Philox-4x32-10 on Python integers (no overflow to avoid)."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & M32]
    return c


def _t(*vals):
    return tuple(torch.tensor([v], dtype=torch.int64) for v in vals)


@pytest.mark.parametrize("i", range(len(KAT)))
def test_philox_known_answers(i):
    ctr, key, want = KAT[i]
    got = rng.philox4x32(_t(*ctr), _t(*key))
    assert [int(w) for w in got] == list(want)
    assert _philox_int(ctr, key) == list(want)


def test_philox_equals_the_integer_version_on_random_words():
    r = np.random.default_rng(0)
    words = r.integers(0, 2 ** 32, (6, 64), dtype=np.uint64).astype(np.int64)
    words[:, 0], words[:, 1] = 0, M32  # the edges of the word range
    got = rng.philox4x32(tuple(torch.from_numpy(w) for w in words[:4]),
                         tuple(torch.from_numpy(w) for w in words[4:]))
    for j in range(words.shape[1]):
        want = _philox_int([int(x) for x in words[:4, j]],
                           [int(x) for x in words[4:, j]])
        assert [int(g[j]) for g in got] == want


def test_mulhilo_splits_the_product_exactly():
    xs = torch.tensor([0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31, M32, 123456789])
    for m in rng.PHILOX_M + (M32, 1):
        hi, lo = rng._mulhilo(m, xs)
        for x, h, lw in zip(xs.tolist(), hi.tolist(), lo.tolist()):
            assert (h, lw) == ((m * x) >> 32, (m * x) & M32)


def _keys(n, seed=0):
    return fz.draw_keys(seed, n)


def test_bits_are_32_bit_words_and_deterministic():
    keys, sweep = _keys(8), torch.arange(8)
    b = rng.bits(keys, sweep, rng.SCORES, 3, 10)
    assert b.shape == (8, 3, 12) and b.dtype == torch.int64
    assert int(b.min()) >= 0 and int(b.max()) <= M32
    assert torch.equal(b, rng.bits(keys.clone(), sweep.clone(), rng.SCORES, 3,
                                   10))


def test_normals_do_not_depend_on_slot_or_batch():
    keys, sweep = _keys(16, seed=1), torch.arange(16) % 5
    z = rng.normal(keys, sweep, rng.RESTART, 4, 33)
    assert z.shape == (16, 4, 33) and z.dtype == torch.float32
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(rng.normal(keys[perm], sweep[perm], rng.RESTART, 4,
                                  33), z[perm])
    for i in (0, 7, 15):  # alone in a batch of one
        assert torch.equal(rng.normal(keys[i:i + 1], sweep[i:i + 1],
                                      rng.RESTART, 4, 33)[0], z[i])
    # a longer draw extends a shorter one element by element
    assert torch.equal(rng.normal(keys, sweep, rng.RESTART, 4, 1001)[..., :33],
                       z)


@pytest.mark.parametrize("change", ["key_lo", "key_hi", "key_second", "sweep",
                                    "factor", "tag"])
def test_normals_change_with_every_input(change):
    keys, sweep = _keys(32, seed=2), torch.arange(32)
    base = rng.normal(keys, sweep, rng.SCORES, 2, 64)
    keys2, sweep2, tag = keys.clone(), sweep.clone(), rng.SCORES
    if change == "key_lo":
        keys2[:, 0] ^= 1
    elif change == "key_hi":
        keys2[:, 0] ^= 1 << 40
    elif change == "key_second":
        keys2[:, 1] ^= 1 << 3
    elif change == "sweep":
        sweep2 += 1
    elif change == "tag":
        tag = rng.PROJECTION
    other = rng.normal(keys2, sweep2, tag, 2, 64)
    if change == "factor":  # factor 1 against factor 0 of the same draw
        base, other = base[:, :1], base[:, 1:]
    same = (base == other).float().mean().item()
    assert same < 0.01  # different streams share no more than chance ties
    corr = torch.corrcoef(torch.stack([base.flatten(), other.flatten()]))[0, 1]
    assert abs(corr.item()) < 5 / np.sqrt(base.numel())


def test_normals_have_standard_moments():
    z = rng.normal(_keys(500, seed=3), torch.arange(500) % 97, rng.SCORES, 4,
                   250).double().flatten()
    n = z.numel()  # 500 000
    se = 5 / np.sqrt(n)
    assert abs(z.mean().item()) < se  # var 1
    assert abs((z ** 2).mean().item() - 1) < se * np.sqrt(2)  # var 2
    assert abs((z ** 3).mean().item()) < se * np.sqrt(15)  # var 15
    assert abs((z ** 4).mean().item() - 3) < se * np.sqrt(96)  # var 96
    assert z.abs().max().item() < 6.67  # the 32-bit uniforms cut the tails
    # both halves of each Box-Muller pair are standard normal
    pairs = z.reshape(-1, 2)
    for half in (pairs[:, 0], pairs[:, 1]):
        assert abs(half.var().item() - 1) < 5 * np.sqrt(2 / half.numel())


def test_bad_inputs_raise():
    keys = _keys(2)
    with pytest.raises(ValueError, match="tag"):
        rng.bits(keys, torch.zeros(2), 4, 1, 4)
    with pytest.raises(ValueError, match="factors"):
        rng.bits(keys, torch.zeros(2), 0, 0, 4)
    with pytest.raises(ValueError, match="int64"):
        rng.bits(keys.int(), torch.zeros(2), 0, 1, 4)
    with pytest.raises(ValueError, match="rows"):
        rng.bits(keys, torch.zeros(3), 0, 1, 4)
    rng.check_keys(keys)
    with pytest.raises(ValueError, match="2\\^62"):
        rng.check_keys(torch.tensor([[-1, 0]]))
    with pytest.raises(ValueError, match="2\\^62"):
        rng.check_keys(torch.tensor([[0, 2 ** 62]]))
    with pytest.raises(ValueError, match="int64"):
        rng.check_keys(torch.zeros((2, 3), dtype=torch.int64))
