"""The port's sharding rules (``repro_torch.parallel.sharding``) beside the
JAX package's: the twin of the rule cases of ``tests/test_sharding.py``
(its HLO and roofline cases are in ``tests/test_torch_hlo.py``).

Each rule case runs on a (1, 1) ``("data", "model")`` mesh in both
packages -- the port's over a gloo group of world size 1 -- and every port
``PartitionSpec`` must equal the reference's ``P`` entry by entry.  Then
``placements`` (spec -> DTensor placements), and every config's
``param_specs``/``state_specs``, leaf for leaf against the reference's
trees: a port parameter ``layers.<i>.<path>`` is slice i of the
reference's stacked ``layers/<path>``, whose spec carries a leading
``None`` for the layer axis (``convert.reference_leaf``).
"""

import types

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.registry import get_family as jget_family  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import reference_leaf  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402
from repro_torch.parallel.sharding import (DEFAULT_RULES, RULE_VARIANTS,  # noqa: E402
                                           SERVE_RULES, PartitionSpec,
                                           constrain, logical_to_spec,
                                           placements, tree_shardings,
                                           use_mesh, weight)
from repro_torch.train.trainer import state_specs  # noqa: E402

P = PartitionSpec


def _jmesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) CPU mesh over a world-size-1 gloo group, destroyed at the
    end of the module so that no later test sees a running group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    started = not dist.is_initialized()
    yield make_host_mesh(("data", "model"), device_type="cpu")
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _same(spec, jspec):
    """Equal entry by entry (a tuple of axes in both, or one name)."""
    return tuple(spec) == tuple(jspec) and len(spec) == len(jspec)


def test_logical_to_spec_basic(mesh):
    spec = logical_to_spec(("batch", None, "tensor"), mesh, DEFAULT_RULES)
    assert spec == P("data", None, "model")  # pod filtered out (not in mesh)
    assert _same(spec, jsh.logical_to_spec(("batch", None, "tensor"), _jmesh(),
                                           jsh.DEFAULT_RULES))


def test_logical_axis_dedupe(mesh):
    """An axis name may appear only once in a PartitionSpec: batch wins."""
    spec = logical_to_spec(("batch", "fsdp"), mesh, DEFAULT_RULES)
    assert spec == P("data", None)
    assert _same(spec, jsh.logical_to_spec(("batch", "fsdp"), _jmesh(),
                                           jsh.DEFAULT_RULES))


def test_serve_rules_kvseq(mesh):
    axes = (None, "batch", "kvseq", "kv", None)
    spec = logical_to_spec(axes, mesh, SERVE_RULES)
    assert spec == P(None, "data", "model", None, None)
    spec_d = logical_to_spec(axes, mesh, DEFAULT_RULES)
    assert spec_d == P(None, "data", None, None, None)
    assert _same(spec, jsh.logical_to_spec(axes, _jmesh(), jsh.SERVE_RULES))
    assert _same(spec_d, jsh.logical_to_spec(axes, _jmesh(), jsh.DEFAULT_RULES))


def test_rules_with_override():
    r = DEFAULT_RULES.with_(seq="model", weight_gather=True)
    assert r.lookup("seq") == "model"
    assert r.weight_gather
    assert DEFAULT_RULES.lookup("seq") is None and not DEFAULT_RULES.weight_gather
    assert set(RULE_VARIANTS) == set(jsh.RULE_VARIANTS)
    for name, rules in RULE_VARIANTS.items():
        want = jsh.RULE_VARIANTS[name]
        assert (rules.rules, rules.weight_gather) == (want.rules,
                                                      want.weight_gather), name


def test_tree_shardings_handles_replicated_sentinel(mesh):
    from torch.distributed.tensor import Replicate, Shard
    tree = {"a": ("fsdp", "tensor"), "b": (), "c": {"d": (None,)}}
    sh = tree_shardings(mesh, tree)
    jsh_ = jsh.tree_shardings(_jmesh(), tree)
    assert sh["b"] == (Replicate(), Replicate())
    assert sh["a"] == (Shard(0), Shard(1))
    assert sh["c"]["d"] == (Replicate(), Replicate())
    assert _same(logical_to_spec(tree["a"], mesh), jsh_["a"].spec)
    assert tuple(jsh_["b"].spec) == ()


def test_weight_gather_constrain(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.ones(4, 4)
    with use_mesh(mesh, DEFAULT_RULES.with_(weight_gather=True)):
        y = weight(x, ("fsdp", "tensor"))
        assert y.shape == x.shape
        # a DTensor sharded over fsdp is gathered over it
        d = DTensor.from_local(x, mesh, (Shard(0), Shard(1)), run_check=False)
        assert weight(d, ("fsdp", "tensor")).placements == (Replicate(), Shard(1))
    with use_mesh(mesh, DEFAULT_RULES):
        y2 = weight(x, ("fsdp", "tensor"))
        assert y2 is x  # identity when off


def test_constrain_noop_without_mesh():
    x = torch.ones(2, 2)
    assert constrain(x, ("batch", None)) is x


def test_placements_split_in_mesh_order():
    """A spec maps tensor dims to mesh axes, placements map mesh dims to
    tensor dims; a dim split over two axes is Shard on both, row-major."""
    from torch.distributed.tensor import Replicate, Shard
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    spec = logical_to_spec(("batch", None, "tensor"), pod, DEFAULT_RULES)
    assert spec == P(("pod", "data"), None, "model")
    assert _same(spec, P(*jsh.logical_to_spec(("batch", None, "tensor"), None,
                                              jsh.DEFAULT_RULES)))
    assert placements(spec, pod) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(), pod) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        placements(P(("data", "pod")), pod)


# ------------------------------------------------- param and state specs
def _ref_spec(tree, name):
    path, layer = reference_leaf(name)
    node = tree
    for part in path.split("."):
        node = node[part]
    return node, layer


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference_leaf_for_leaf(arch):
    cfg = get_config(arch, reduced=True)
    specs = get_family(cfg).param_specs(cfg)
    model = get_family(cfg).model(cfg, torch.device("meta"))
    assert list(specs) == [n for n, _ in model.named_parameters()]
    jcfg = jget_config(arch, reduced=True)
    want = jget_family(jcfg).param_specs(jcfg)
    seen = set()
    for name, spec in specs.items():
        ref, layer = _ref_spec(want, name)
        assert tuple(ref) == (spec if layer is None else (None,) + spec), name
        seen.add(reference_leaf(name)[0])
    n_ref = len(jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
    assert len(seen) == n_ref


@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-2.7b", "whisper-base"])
def test_state_specs_are_zero3(arch, mesh):
    cfg = get_config(arch, reduced=True)
    st = state_specs(cfg)
    assert st.params == st.opt.m == st.opt.v
    assert st.opt.step == () and st.rng == ()
    jst = jtrainer.state_specs(jget_config(arch, reduced=True))
    assert jst.opt.step == () and jst.rng == ()
    for name, spec in st.opt.m.items():
        ref, layer = _ref_spec(jst.opt.m, name)
        assert tuple(ref) == (spec if layer is None else (None,) + spec), name
    sh = tree_shardings(mesh, st, DEFAULT_RULES)
    assert type(sh) is type(st) and type(sh.opt) is type(st.opt)
    assert set(sh.params) == set(st.params)
