"""Shared helpers of the port's conformance twins (``tests/test_torch_*.py``
twins of the JAX package's main-path tests).

A *side* is one package -- ``repro`` or ``repro_torch`` -- with the data a
case writes: a producer hands ``side.data(a)`` to ``create_dataset`` (the
numpy array ``a`` itself on the reference side, a CPU tensor made from it
on the port's), and a consumer hands what it received to
``side.record((task, instance, producer, step), value)``.  ``run_both``
runs one case through both packages on the same inputs and
``assert_same`` holds them equal: the bytes each consumer instance
received, keyed by (task, instance, producer, step), the reports'
``total_served`` and ``total_bytes_moved``, the transport counters
(``transport_stats()``), and the plan cache's calls, size and hit rate
over distinct plans.  Two threads that miss the same plan key at once
both count a miss in both packages (``PlanCache.get`` compiles outside its
lock), so raw hit and miss counts vary from run to run; their sum and the
number of distinct plans do not.
"""

import threading
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import datamodel as jdm
from repro.core import redistribute as jred
from repro_torch import convert
from repro_torch.core import datamodel as tdm
from repro_torch.core import redistribute as tred

CPU = torch.device("cpu")

# transport counters that do not depend on thread timing
COPY_COUNTERS = ("copies", "bytes_copied", "cow_copies",
                 "redist_planned_bytes", "redist_shipped_bytes",
                 "redist_baseline_bytes", "redist_aligned", "redist_slabs",
                 "reshard_pack", "reshard_numpy")


@dataclass
class Side:
    name: str
    core: Any
    dm: Any
    red: Any
    got: Dict[Any, Any] = field(default_factory=dict)
    lock: Any = field(default_factory=threading.Lock)

    @property
    def port(self) -> bool:
        return self.name == "torch"

    @property
    def h5(self):
        return self.core.h5

    def data(self, a):
        """The payload a producer writes: a tensor on the port's side."""
        a = np.asarray(a)
        return convert.tensor_from_numpy(a, CPU) if self.port else a

    def host(self, x):
        """What arrived, as a host array."""
        if isinstance(x, torch.Tensor):
            return convert.numpy_from_tensor(x)
        if hasattr(x, "read_direct"):
            x = x.read_direct()
        return self.host(x) if isinstance(x, torch.Tensor) else np.asarray(x)

    def record(self, key, value) -> None:
        """Keep what arrived under ``key``; a replay after a restart may
        deliver a key again, and must deliver the same bytes."""
        a = np.ascontiguousarray(self.host(value))
        got = (a.dtype.str, a.shape, a.tobytes())
        with self.lock:
            assert self.got.setdefault(key, got) == got, \
                f"{self.name}: {key} delivered again with other bytes"

    def wilkins(self, doc, funcs, **kw):
        if self.port:
            kw.setdefault("devices", [CPU])
        return self.core.Wilkins(doc, funcs, **kw)


def sides():
    return (Side("torch", tcore, tdm, tred), Side("jax", jcore, jdm, jred))


@dataclass
class Run:
    side: Side
    result: Any
    stats: Dict[str, Any]
    plans: Dict[str, Any]

    @property
    def report(self):
        return self.result


def run_both(case, *args, **kw):
    """``case(side, *args, **kw)`` through the port and then the reference,
    each from reset transport counters and an empty plan cache."""
    out = []
    for side in sides():
        side.red.reset_plan_cache()
        side.dm.reset_transport_stats()
        res = case(side, *args, **kw)
        out.append(Run(side, res, side.dm.transport_stats().snapshot(),
                       side.red.plan_cache().snapshot()))
    return out[0], out[1]


def hit_rate(snap) -> float:
    calls = snap["hits"] + snap["misses"]
    return 1 - snap["size"] / calls if calls else 0.0


def assert_same_deliveries(t: Run, j: Run, keys=None) -> None:
    tg, jg = t.side.got, j.side.got
    if keys is None:
        assert sorted(tg) == sorted(jg)
        keys = tg
    for k in keys:
        assert tg[k] == jg[k], f"{k}: the packages received different bytes"


def assert_same(t: Run, j: Run, report=True, counters=COPY_COUNTERS) -> None:
    """Equal deliveries, report totals, transport counters and plan-cache
    rate over distinct plans."""
    assert_same_deliveries(t, j)
    if report:
        assert t.report.total_served == j.report.total_served
        assert t.report.total_bytes_moved == j.report.total_bytes_moved
    for k in counters:
        assert t.stats[k] == j.stats[k], (k, t.stats[k], j.stats[k])
    tp, jp = t.plans, j.plans
    assert tp["hits"] + tp["misses"] == jp["hits"] + jp["misses"]
    assert tp["size"] == jp["size"]
    assert hit_rate(tp) == hit_rate(jp)


def owned(dm, red, shape, m):
    own = dm.BlockOwnership()
    for r, (s, sh) in enumerate(red.even_blocks(tuple(shape), m)):
        own.add(r, s, sh)
    return own
