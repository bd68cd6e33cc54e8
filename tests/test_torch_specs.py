"""The dry run's inputs and cells (``repro_torch.launch.specs``) and each
family's ``cache_specs`` beside the JAX package's.

* ``cache_specs`` of every family equals the reference's leaf for leaf;
* ``input_specs`` (``meta`` tensors) equals the reference's ``jax.eval_shape``
  leaves in shape and dtype for every arch and shape, a port parameter
  ``layers.<i>.<path>`` being slice i of the reference's stacked leaf
  (``convert.reference_leaf``);
* ``make_cell``'s per-argument specs equal the reference ``make_cell``'s
  ``in_shardings`` specs entry by entry, on a (1, 1) ``("data", "model")``
  mesh in both packages (the port's over a fake group of one rank).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.registry import get_family as jget_family  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, shapes_for  # noqa: E402
from repro_torch.convert import reference_leaf  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import virtual_ranks  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402


def _leaf(tree, name):
    """(the reference leaf of port name ``name``, stacked?)."""
    path, layer = reference_leaf(name)
    node = tree
    for part in path.split("."):
        node = node[part]
    return node, layer is not None


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = dict(_flat(get_family(cfg).cache_specs(cfg)))
    want = dict(_flat(jget_family(jcfg).cache_specs(jcfg)))
    assert got == want
    # keyed as the port's cache is
    cache = get_family(cfg).init_cache(cfg, 2, 8, device=torch.device("meta"))
    assert set(dict(_flat(cache))) == set(got)
    for name, axes in got.items():
        assert len(axes) in (0, dict(_flat(cache))[name].dim())


def _same_leaf(t, ref, stacked):
    shape = tuple(ref.shape)[1:] if stacked else tuple(ref.shape)
    assert tuple(t.shape) == shape, (tuple(t.shape), tuple(ref.shape))
    assert str(t.dtype).split(".")[-1] == str(ref.dtype)


def _same_params(named, ref_tree):
    seen = {}
    for name, t in named.items():
        ref, stacked = _leaf(ref_tree, name)
        _same_leaf(t, ref, stacked)
        seen.setdefault(reference_leaf(name)[0], []).append(name)
    for key, names in seen.items():
        ref, stacked = _leaf(ref_tree, names[0])
        assert len(names) == (ref.shape[0] if stacked else 1), key
    assert len(seen) == len(jax.tree.leaves(ref_tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference_eval_shape(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in shapes_for(cfg):
        got = specs.input_specs(cfg, shape)
        want = jspecs.input_specs(jcfg, shape)
        assert set(got) == set(want), shape.name
        assert set(got["batch"]) == set(want["batch"])
        for k, t in got["batch"].items():
            assert t.device.type == "meta"
            _same_leaf(t, want["batch"][k], False)
        if shape.kind == "train":
            st, jst = got["state"], want["state"]
            _same_params(dict(st.params.named_parameters()), jst.params)
            _same_params(st.opt.m, jst.opt.m)
            _same_params(st.opt.v, jst.opt.v)
            _same_leaf(st.opt.step, jst.opt.step, False)
            assert np.shape(st.rng) == jst.rng.shape
            assert all(p.device.type == "meta" for p in st.params.parameters())
            continue
        _same_params(dict(got["params"].named_parameters()), want["params"])
        gc, wc = dict(_flat(got["cache"])), dict(_flat(want["cache"]))
        assert set(gc) == set(wc)
        for k in gc:
            _same_leaf(gc[k], wc[k], False)
        if shape.kind == "decode":
            _same_leaf(got["token"], want["token"], False)


def _jmesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _spec(s):
    return tuple(s)


def _same_specs(got, want, what):
    """A port spec tree (params keyed by port name) against the reference's
    ``NamedSharding`` tree."""
    if isinstance(got, dict) and got and "." in next(iter(got)):
        for name, spec in got.items():
            ref, stacked = _leaf(want, name)
            ref = tuple(ref.spec)
            assert (ref[1:] if stacked else ref) == tuple(spec), (what, name)
            if stacked:
                assert ref[0] is None
        return
    if isinstance(got, dict):
        assert set(got) == set(want), what
        for k in got:
            _same_specs(got[k], want[k], f"{what}.{k}")
        return
    if hasattr(got, "_fields"):
        for f in got._fields:
            _same_specs(getattr(got, f), getattr(want, f), f"{what}.{f}")
        return
    assert tuple(got) == tuple(want.spec), (what, got, want.spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_cell_specs_equal_the_reference_in_shardings(arch):
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    with virtual_ranks(1):
        mesh = make_host_mesh(("data", "model"), device_type="cpu")
        for shape in shapes_for(get_config(arch)):
            cell = specs.make_cell(cfg, shape, mesh)
            jcell = jspecs.make_cell(jcfg, shape, _jmesh())
            assert cell.name == jcell.name
            assert cell.donate_argnums == jcell.donate_argnums
            assert len(cell.specs) == len(jcell.in_shardings) == len(cell.args)
            for i, (got, want) in enumerate(zip(cell.specs, jcell.in_shardings)):
                _same_specs(got, want, f"{shape.name}[{i}]")
            assert len(cell.placements) == len(cell.specs)
