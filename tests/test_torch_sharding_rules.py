"""The port's logical-axis sharding rules (``repro_torch.nn.common``) and
logical-axes trees (``param_logical``, ``cache_logical``) against the
reference's: ``spec_for`` on every logical tuple both trees produce, for
all ten architectures (smoke and full), over the axis names of both
production meshes and a ``pipe`` mesh, under the default, the
sequence-parallel and the dry-run's decode rules; ``param_logical`` equal
to ``repro.nn.transformer.abstract_init(cfg)[1]`` leaf path for leaf path;
and ``shard`` the identity without a mesh."""
import jax
import pytest
import torch

from repro.configs.registry import ARCHS as RARCHS
from repro.nn import common as RC
from repro.nn import transformer as RT
from repro_torch.configs.registry import ARCHS
from repro_torch.nn import common as C
from repro_torch.nn import transformer as T


def _mesh(names, shape):
    class FakeMesh:  # the duck type the reference's test_roofline uses
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    FakeMesh.devices.size = int(torch.tensor(shape).prod())
    return FakeMesh


MESHES = [_mesh(("data", "model"), (16, 16)),
          _mesh(("pod", "data", "model"), (2, 16, 16)),
          _mesh(("pipe",), (4,)), _mesh(("data", "pipe"), (2, 4))]


def _rule_sets():
    decode = dict(RC.DEFAULT_RULES, seq="model")
    long_ctx = dict(RC.DEFAULT_RULES, batch=None, seq=("data", "model"),
                    seq_res=None)
    return [RC.DEFAULT_RULES, RC.SEQ_PARALLEL_RULES, decode, long_ctx]


def _tuples(tree) -> list:
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


def test_the_rule_tables_are_the_references():
    assert C.DEFAULT_RULES == RC.DEFAULT_RULES
    assert C.SEQ_PARALLEL_RULES == RC.SEQ_PARALLEL_RULES


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_spec_for_matches_the_reference_on_every_logical_tuple(arch_id, which):
    cfg = getattr(ARCHS[arch_id], which)()
    tuples = set(_tuples(T.param_logical(cfg)) + _tuples(T.cache_logical(cfg)))
    tuples |= {("batch", "seq", "heads", None), ("batch", "seq", "embed_act"),
               ("batch", "seq_res", "embed_act"), ("batch", "seq", "vocab"),
               ("batch", "experts", None, "mlp"), ("batch",)}
    n = 0
    for mesh in MESHES:
        for rules in _rule_sets():
            for lg in tuples:
                want = tuple(RC.spec_for(lg, mesh, rules))
                assert C.spec_for(lg, mesh, dict(rules)) == want, (lg, rules)
                n += 1
    assert n >= 16 * 10


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_param_logical_is_the_references_tree(arch_id, which):
    want = RT.abstract_init(getattr(RARCHS[arch_id], which)())[1]
    got = T.param_logical(getattr(ARCHS[arch_id], which)())
    leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    want_l = jax.tree_util.tree_flatten_with_path(want, is_leaf=leaf)[0]
    got_l = jax.tree_util.tree_flatten_with_path(got, is_leaf=leaf)[0]
    assert got_l == want_l


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_leaf_logical_names_every_parameter_at_its_rank(arch_id):
    cfg = ARCHS[arch_id].smoke()
    lg = T.leaf_logical(cfg)
    params = dict(T.abstract_init(cfg).named_parameters())
    assert set(lg) == set(params)
    for name, p in params.items():
        assert len(lg[name]) == p.dim(), name


def test_placements_give_one_shard_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES[1]
    spec = C.spec_for(("batch", "seq", "heads", None), mesh, C.DEFAULT_RULES)
    assert spec == (("pod", "data"), None, "model", None)
    assert C.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert C.placements((None, None), MESHES[0]) == [Replicate(), Replicate()]


def test_shard_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert C.current_mesh() is None
    assert C.shard(x, "batch", "seq", "embed_act") is x
    with C.sharding_ctx(None):
        assert C.shard(x, "batch", "seq", "embed_act") is x
    with C.sharding_ctx(MESHES[0]):
        assert C.current_mesh()[1] is C.DEFAULT_RULES
        assert C.shard(x, "batch", "seq", "embed_act") is x  # a plain tensor
    assert C.current_mesh() is None


def test_param_sharding_places_every_leaf_by_its_rule():
    from torch.distributed.tensor import Replicate, Shard

    cfg = ARCHS["llama3.2-3b"].full()
    mesh = MESHES[0]
    tree = C.param_sharding(T.param_logical(cfg), mesh)
    assert tree["embed"] == [Shard(1), Shard(0)]  # embed over data, vocab over model
    assert tree["lm_head"] == [Shard(0), Shard(1)]
    assert tree["final_ln"]["scale"] == [Replicate(), Replicate()]
    # stacked blocks: ("layers", "embed", "heads") -> layers stay whole
    assert tree["blocks"][0]["attn"]["q"]["w"] == [Shard(1), Shard(2)]
    leaves = _tuples(T.param_logical(cfg))
    placed = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, list) and not isinstance(x[0], (dict, list)))
    assert len(placed) == len(leaves)
