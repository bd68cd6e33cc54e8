"""Sharded dry run: trace every (arch x shape x mesh) cell over virtual
ranks (``src/repro/launch/dryrun.py``).

For each cell this shows, without the hardware:
  * the sharding rules are coherent (the step traces on the mesh, every
    layout change a redistribution DTensor knows),
  * what rank 0 holds (its argument, output and temporary bytes),
  * and the roofline terms (the analytic FLOPs and bytes of ``hlo``, the
    collective bytes of the trace).

The reference lowers and compiles each cell with XLA on 256 or 512
virtual host devices.  Here the ranks are a ``fake`` process group of 256
(pod mesh, (16, 16)) or 512 (multipod, (2, 16, 16)) ranks in one process:
collectives on it move nothing and return at once.  The cell's arguments
are ``meta`` tensors (``specs.input_specs``), made ``FakeTensor``s on the
device and placed as ``DTensor``s with the cell's placements, so nothing
is allocated; the step runs once under ``FakeTensorMode``, which gives
every result its shape without computing it.  The trace runs inside three
recorders: ``hlo.CommLog`` (every collective, by kind, bytes and group),
``FlopLog`` (the raw FLOPs by torch's own formulas, those of
``FlopCounterMode``: ``raw_cost_analysis``) and ``MemLog``
(rank 0's live bytes: ``memory``).  ``MemLog`` is a dispatch mode that
counts every storage an op creates until it is freed: torch's own
``MemTracker`` refuses a module called more than once in its region, as
a step with gradient accumulation or the hybrid's shared block calls
them.  A dispatch mode runs before the ``DTensor`` subclass, so each
recorder hands an op on ``DTensor``s back (``hlo.desugars``): DTensor
then lowers it, with the recorders still active, to the ops on rank 0's
shards and the collectives of its redistributions, which is what they
count.  The trace is the
port's lowering, so ``t_lower_s`` is its time; there is no compiler to
time, so ``t_compile_s`` is ``null``.

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
(the reference's stay in ``results/dryrun``).  The cells trace on the card
(``--device cuda``, the default, which raises without CUDA) or with
``--device cpu``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, SHAPES, Shape, get_config, shapes_for
from ..parallel.sharding import DEFAULT_RULES, RULE_VARIANTS, SERVE_RULES
from ..train.trainer import TrainState
from . import hlo
from .mesh import make_host_mesh, make_production_mesh
from .specs import make_cell, place_args

__all__ = ["RESULTS_DIR", "virtual_ranks", "FakeMode", "MemLog", "FlopLog",
           "weight_gathers", "trace_cell", "run_cell", "save_result",
           "local_bytes", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@contextmanager
def virtual_ranks(n: int):
    """A ``fake`` process group of ``n`` ranks, this process rank 0, for
    the duration (destroyed on exit) when no group is running; a running
    group of ``n`` ranks is used as it is, one of another size raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is running: "
                f"the dry run needs {n} (or none, to start its own)")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree: Any):
    """Every tensor of an argument tree (a model's parameters, a state's
    parameters and moments, dicts, named tuples)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)


def local_bytes(tree: Any) -> int:
    """The bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for t in _leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def _materialize(tree: Any, dev: torch.device) -> Any:
    """A ``meta`` argument tree as uninitialised tensors on ``dev`` (fake
    ones under ``FakeTensorMode``), of the same structure."""
    if isinstance(tree, torch.nn.Module):
        return tree.to_empty(device=dev)
    if isinstance(tree, TrainState):
        return tree._replace(params=_materialize(tree.params, dev),
                             opt=_materialize(tree.opt, dev))
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device=dev)
    if isinstance(tree, dict):
        return {k: _materialize(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(v, dev) for v in tree))
    return tree


class FakeMode(FakeTensorMode):
    """``FakeTensorMode`` that knows when it is entered again inside
    itself: DTensor's sharding propagation re-enters the ambient fake mode
    to run each new op once at its global shape, work that no rank does
    and that ``MemLog`` and ``FlopLog`` therefore skip (``nested``)."""

    depth = 0

    def __enter__(self):
        self.depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self.depth -= 1
        return super().__exit__(*exc)

    @property
    def nested(self) -> bool:
        return self.depth > 1


class MemLog(TorchDispatchMode):
    """Live and peak bytes of the storages of every tensor given to
    ``track`` or made by an op inside the mode (a ``DTensor`` counts its
    local shard), each counted once and until it is freed; ops run inside
    a nested ``fake`` mode are not counted."""

    def __init__(self, fake: Optional[FakeMode] = None):
        super().__init__()
        self.fake = fake
        self.live: Dict[int, int] = {}
        self.refs: Dict[int, Any] = {}
        self.now = self.peak = 0

    def track(self, t: Any) -> None:
        t = getattr(t, "_local_tensor", t)
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return              # a meta tensor holds no memory anywhere
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        self.refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if hlo.desugars(func, types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not (self.fake and self.fake.nested):
            for t in tree_leaves(out):
                self.track(t)
        return out


class FlopLog(TorchDispatchMode):
    """This rank's FLOPs, by ``FlopCounterMode``'s formulas, over the
    local ops (``DTensor`` ops are handed back and lowered first); ops run
    inside a nested ``fake`` mode are not counted."""

    def __init__(self, fake: Optional[FakeMode] = None):
        super().__init__()
        self.fake = fake
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if hlo.desugars(func, types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        count = flop_registry.get(getattr(func, "_overloadpacket", None))
        if count is not None and not (self.fake and self.fake.nested):
            self.flops += float(count(*args, **(kwargs or {}), out_val=out))
        return out


def weight_gathers(calls, args) -> Tuple[Dict[str, int], int]:
    """The recorded collectives (``CommLog.calls``) that gather a weight,
    counted by result shape (``"3072x192"``), and their bytes: the
    all-gathers whose result is the local shard of a split parameter of
    ``args`` (a model or a training state first) gathered over the call's
    group, ``(n * l0, l1, ...)``, since the functional all-gather stacks
    the pieces along the first dimension whichever dimension is split.
    Weights with equal shards share a shape."""
    model = args[0].params if isinstance(args[0], TrainState) else args[0]
    counts: Dict[str, int] = {}
    if not isinstance(model, torch.nn.Module):
        return counts, 0
    shards = {tuple(p.to_local().shape) for p in model.parameters()
              if hasattr(p, "to_local") and p.to_local().shape != p.shape}
    total = 0
    for kind, nbytes, group, shape in calls:
        if kind == "all-gather" and shape and shape[0] % group == 0 and \
                (shape[0] // group,) + tuple(shape[1:]) in shards:
            key = "x".join(map(str, shape))
            counts[key] = counts.get(key, 0) + 1
            total += nbytes
    return counts, total


def trace_cell(cell, mesh, dev: torch.device) -> Dict[str, Any]:
    """Place the cell's arguments on ``mesh`` as fake ``DTensor``s on
    ``dev`` and run ``cell.fn`` once under ``FakeTensorMode`` with the
    three recorders.  Returns the trace time, rank 0's bytes, the
    collectives and the raw FLOPs."""
    with FakeMode(allow_non_fake_inputs=True) as fake:
        args = place_args(cell, mesh, tuple(_materialize(a, dev) for a in cell.args))
        arg_bytes = local_bytes(args)
        arg_storages = {t.to_local().untyped_storage()._cdata
                        if hasattr(t, "to_local") else t.untyped_storage()._cdata
                        for t in _leaves(args)}
        mem = MemLog(fake)
        for t in _leaves(args):
            mem.track(t)
        comm = hlo.CommLog()
        flops = FlopLog(fake)
        t0 = time.monotonic()
        with mem, comm, flops:
            out = cell.fn(*args)
        t_lower = time.monotonic() - t0
        out_bytes = 0
        for t in _leaves(out):
            local = t.to_local() if hasattr(t, "to_local") else t
            if local.untyped_storage()._cdata not in arg_storages:
                out_bytes += local.numel() * local.element_size()
        peak_total = mem.peak
        n_wg, b_wg = weight_gathers(comm.calls, args)
    return {"t_lower_s": t_lower, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(0, peak_total - arg_bytes),
            "collectives": comm.stats(), "collective_calls": comm.calls,
            "weight_gathers": n_wg, "weight_gather_bytes": b_wg,
            "flops": float(flops.flops)}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             rules=None, accum_steps: int = 1, tag: str = "",
             compress_grads: bool = False,
             cfg_overrides: Optional[dict] = None,
             variant: Optional[str] = None,
             device: str = "cuda", *, cfg=None, shape: Optional[Shape] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """Trace one cell and return the reference's result keys.  ``cfg``,
    ``shape`` and ``mesh_shape`` (a ("data", "model") or ("pod", "data",
    "model") shape) replace the named config, shape and mesh (the tests'
    reduced cells)."""
    cfg = cfg or get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = shape or next(s for s in SHAPES if s.name == shape_name)
    dims, axes = MESHES[mesh_name]
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), MESHES["pod" if len(mesh_shape) == 2
                                              else "multipod"][1]
    n_dev = math.prod(dims)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)

    with virtual_ranks(n_dev):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                        device_type=dev.type)
        else:
            mesh = make_host_mesh(axes, device_type=dev.type, shape=dims)
        cell = make_cell(cfg, shape, mesh, rules=rules, accum_steps=accum_steps,
                         compress_grads=compress_grads)
        tr = trace_cell(cell, mesh, dev)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))

    # analytic per-device flops/bytes (see hlo.py); raw counts recorded below
    n_data = sizes.get("pod", 1) * sizes["data"]
    n_model = sizes["model"]
    if variant == "dp":      # pure DP folds the model axis into data
        n_data, n_model = n_data * n_model, 1
    ana = hlo.analytic_stats(cfg, shape, n_data, n_model, accum_steps=accum_steps)
    coll = tr["collectives"]
    rf = hlo.Roofline(flops=ana["flops"], hbm_bytes=ana["hbm_bytes"],
                      coll_bytes=float(coll.total_bytes),
                      model_flops=hlo.model_flops_per_device(cfg, shape, n_dev))
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "tag": tag,
        "n_devices": n_dev,
        "device": dev.type,
        "ok": True,
        "t_lower_s": tr["t_lower_s"],
        "t_compile_s": None,
        "memory": {
            "argument_bytes": tr["argument_bytes"],
            "output_bytes": tr["output_bytes"],
            "temp_bytes": tr["temp_bytes"],
            "peak_bytes": tr["argument_bytes"] + tr["temp_bytes"],
            "tracker": "MemLog",
        },
        "collectives": {
            "bytes_by_kind": coll.bytes_by_kind,
            "count_by_kind": coll.count_by_kind,
            "weight_gathers": tr["weight_gathers"],
            "weight_gather_bytes": tr["weight_gather_bytes"],
        },
        "roofline": rf.to_dict(),
        "raw_cost_analysis": {  # FlopLog over the trace
            "flops": tr["flops"],
            "bytes_accessed": None,
        },
    }


def save_result(res: dict, results_dir: Optional[str] = None) -> str:
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    tag = f"__{res['tag']}" if res.get("tag") else ""
    name = f"{res['arch']}__{res['shape']}__{res['mesh']}{tag}.json"
    path = os.path.join(results_dir, name)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", default=None, choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--accum-steps", type=int, default=None,
                    help="grad-accum microbatches for train shapes (default 4, "
                         "as the reference's)")
    ap.add_argument("--weight-gather", action="store_true",
                    help="FSDP weight-gather sharding mode (see "
                         "parallel/sharding.py)")
    ap.add_argument("--variant", default=None,
                    help="named rule variant from parallel.sharding."
                         "RULE_VARIANTS (wg/sp/dp/serve_wg/serve_repl/moe_a2a); "
                         "becomes the result tag")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", choices=["none", "dots", "full"], default=None,
                    help="override the config's activation-checkpoint policy")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the fake tensors live (cuda raises without a card)")
    ap.add_argument("--results-dir", default=None,
                    help="where the result files go (default results/dryrun_torch)")
    args = ap.parse_args(argv)
    results_dir = args.results_dir or RESULTS_DIR
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to trace "
                           "the cells on the CPU")

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        cell_shapes = ([s for s in shapes_for(cfg) if s.name == args.shape]
                       if args.shape else shapes_for(cfg))
        for shape in cell_shapes:
            for mesh_name in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                path = os.path.join(
                    results_dir, f"{arch}__{shape.name}__{mesh_name}{tag}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {arch} {shape.name} {mesh_name}")
                    continue
                accum = args.accum_steps
                if accum is None:
                    accum = 4 if shape.kind == "train" else 1
                rules = None
                tag = args.tag
                if args.variant:
                    rules = RULE_VARIANTS[args.variant]
                    tag = tag or args.variant
                elif args.weight_gather:
                    base = DEFAULT_RULES if shape.kind == "train" else SERVE_RULES
                    rules = base.with_(weight_gather=True)
                try:
                    overrides = {"remat": args.remat} if args.remat else None
                    if args.variant == "moe_a2a":
                        overrides = dict(overrides or {})
                        overrides["moe_dispatch"] = "a2a"
                    res = run_cell(arch, shape.name, mesh_name, tag=tag,
                                   rules=rules, accum_steps=accum,
                                   compress_grads=args.compress_grads,
                                   cfg_overrides=overrides,
                                   variant=args.variant, device=args.device)
                    p = save_result(res, results_dir)
                    r = res["roofline"]
                    print(f"[ok] {arch} {shape.name} {mesh_name} "
                          f"trace={res['t_lower_s']:.1f}s "
                          f"mem={res['memory']['peak_bytes']/2**30:.2f}GiB "
                          f"tc={r['t_compute']*1e3:.2f}ms "
                          f"tm={r['t_memory']*1e3:.2f}ms "
                          f"tx={r['t_collective']*1e3:.2f}ms "
                          f"bound={r['bottleneck']} -> {p}")
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {arch} {shape.name} {mesh_name}: "
                          f"{type(e).__name__}: {e}")
                    traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
