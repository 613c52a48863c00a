"""The port's synthetic LM token stream (``repro_torch.data.tokens``) against
the reference's ``repro.data.tokens``: bit-equal batches over seeds, shard
partitions and steps, after a ``restore`` too, and the stream's planted
structure."""
import numpy as np
import pytest

from repro.data.tokens import TokenConfig as RConfig
from repro.data.tokens import TokenDataset as RDataset
from repro_torch.data.tokens import TokenConfig, TokenDataset


def _pair(**kw):
    return TokenDataset(TokenConfig(**kw)), RDataset(RConfig(**kw))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab,seq,batch", [(512, 32, 2), (1000, 17, 3),
                                             (128256, 16, 2)])
def test_batches_bit_equal_the_references(seed, vocab, seq, batch):
    port, ref = _pair(vocab=vocab, seq_len=seq, batch_size=batch, seed=seed)
    for _ in range(4):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("num_shards", [2, 4])
def test_shards_partition_the_references_stream(num_shards):
    """Shard i's step t is batch t * num_shards + i of the global stream,
    as the reference's: the shards' batches, interleaved, are the
    unsharded reference's own stream, and each shard equals its reference
    shard."""
    kw = dict(vocab=512, seq_len=16, batch_size=2, seed=3)
    shards = [TokenDataset(TokenConfig(**kw, num_shards=num_shards,
                                       shard_index=i))
              for i in range(num_shards)]
    ref_shards = [RDataset(RConfig(**kw, num_shards=num_shards,
                                   shard_index=i))
                  for i in range(num_shards)]
    whole = RDataset(RConfig(**kw))
    for _ in range(3):
        for s, r in zip(shards, ref_shards):
            got = s.next_batch()["tokens"]
            np.testing.assert_array_equal(got, r.next_batch()["tokens"])
            np.testing.assert_array_equal(got, whole.next_batch()["tokens"])


def test_restore_resumes_the_references_stream():
    port, ref = _pair(vocab=512, seq_len=16, batch_size=2, seed=5)
    for _ in range(3):
        port.next_batch()
    state = port.state()
    assert state == {"step": 3}
    after = [port.next_batch()["tokens"] for _ in range(2)]
    resumed = TokenDataset(TokenConfig(512, 16, 2, seed=5))
    resumed.restore(state)
    ref.restore({"step": 3})
    for want in after:
        got = resumed.next_batch()["tokens"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref.next_batch()["tokens"])
    assert resumed.state() == ref.state() == {"step": 5}


def test_iteration_and_planted_structure():
    """``__iter__`` yields next_batch's stream; about 80 % of transitions
    follow the planted successor table, so a model can learn it."""
    ds = TokenDataset(TokenConfig(256, 64, 8, seed=2))
    it = iter(ds)
    first = next(it)["tokens"]
    np.testing.assert_array_equal(
        first, TokenDataset(TokenConfig(256, 64, 8, seed=2)).next_batch()[
            "tokens"])
    toks = np.concatenate([next(it)["tokens"] for _ in range(8)])
    assert toks.min() >= 0 and toks.max() < 256
    succ = ds._succ
    follows = (succ[toks[:, :-1]] == toks[:, 1:, None]).any(-1)
    assert 0.75 < follows.mean() < 0.9
