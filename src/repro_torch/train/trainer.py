"""Family-agnostic training step: loss -> grad -> (accumulate) -> AdamW
(``src/repro/train/trainer.py``).

``make_train_step`` builds ``train_step(state, batch)`` for any ported
arch config.  The reference jits the step and donates the old state; here
the step runs eagerly on the state's device and updates the model's
parameters and the moments in place (at full width a second copy of the
state would not fit on the card), returning the same objects in a new
``TrainState``.

Microbatch gradient accumulation (``accum_steps``) runs the microbatches
one after another and updates the weights once per global batch, the
accumulator in the optimizer-state dtype, added to and divided in place.  Optional int8 gradient
compression (``compress_grads``): each microbatch's gradient is quantized
per leaf (symmetric, absmax scale) before it enters the accumulator, with
an error-feedback residual folded into the next microbatch, as in the
reference; a leaf is the reference's, so the layers of a stacked leaf
share one scale.

``state_specs`` is the logical-axis tree of the whole state (ZeRO-3: the
moments like the parameters), keyed as the state is.  With plain-tensor
parameters a batch placed on a mesh (``data.shard_batch``) enters the step
as this rank's local shard.  With the parameters as ``DTensor``s (placed
by ``parallel.sharding.place_module``) the step is the sharded one: the
batch is constrained to the batch axes (reference trainer.py:96) and the
gradients come back with the parameters' layouts, reduced across the data
ranks by DTensor's redistribution as GSPMD reduces the reference's; under
``weight_gather`` rules they are constrained to the parameter layout (the
reference's ZeRO hint, trainer.py:151: a reduce-scatter).

Inside a traced ``Wilkins`` run (the task's VOL, pushed on its thread,
holds the run's ``SpanRecorder``) each step records ``train.step`` and its
phases ``train.forward``, ``train.backward`` (each microbatch's) and
``train.optimizer`` (PORT.md "Tracing on the card"); on a CUDA device each
also carries its device interval, between timing events recorded on the
stream at the phase boundaries.  ``train.optimizer`` counts the update's
``leaves`` and the fused AdamW kernels' ``launches`` in it (0 on the CPU).
Untraced, a step pays one lookup and one ``None`` test.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.vol import current_vol
from ..kernels.adamw import NAMES as ADAMW_KERNELS
from ..kernels.build import launch_counts
from ..models.registry import get_family
from ..parallel.sharding import (DEFAULT_RULES, axis_size, constrain,
                                 current_mesh, current_rules, local_apply,
                                 mesh_sharding, place, place_module,
                                 place_tree, use_mesh)
from ..serve.engine import default_device
from .optim import (AdamWConfig, OptState, adamw_init, adamw_update,
                    reference_order)

__all__ = ["TrainState", "make_train_step", "init_state", "state_specs",
           "place_state"]


class TrainState(NamedTuple):
    params: Any          # the model (an nn.Module of the config's family)
    opt: OptState
    rng: np.ndarray      # uint32[2], the reference's PRNGKey(0)


def init_state(generator: Optional[torch.Generator], cfg,
               opt_cfg: Optional[AdamWConfig] = None, device=None) -> TrainState:
    """A model of ``cfg`` drawn from ``generator`` on ``device`` (default
    ``cuda:0``, raising without CUDA) and zero AdamW moments."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    device = default_device(device)
    model = get_family(cfg).init(cfg, generator, device)
    return TrainState(params=model, opt=adamw_init(model, opt_cfg),
                      rng=np.zeros(2, np.uint32))


def state_specs(cfg) -> TrainState:
    """Logical-axis spec tree for the full TrainState (ZeRO-3: m/v like
    params), each keyed by parameter name."""
    pspecs = get_family(cfg).param_specs(cfg)
    return TrainState(params=pspecs, opt=OptState(step=(), m=pspecs, v=pspecs),
                      rng=())


def place_state(state: TrainState, plc: TrainState, mesh: Any) -> TrainState:
    """``state`` with its parameters (replaced in place in the model) and
    moments as ``DTensor``s with the placements ``plc``
    (``tree_shardings(mesh, state_specs(cfg), rules)``): each rank keeps
    its shard of the whole state it holds."""
    place_module(state.params, plc.params, mesh)
    return state._replace(opt=state.opt._replace(
        m=place_tree(state.opt.m, plc.opt.m, mesh),
        v=place_tree(state.opt.v, plc.opt.v, mesh)))


def _local(v: Any) -> Any:
    """This rank's shard of a batch leaf placed on a mesh (a ``DTensor``);
    anything else as it is."""
    return v.to_local() if hasattr(v, "to_local") else v


def _is_sharded(model) -> bool:
    return hasattr(next(model.parameters()), "placements")


def _batch_leaf(v: Any, dev) -> Any:
    """A batch leaf for the sharded step: a ``DTensor`` constrained to the
    batch axes (a host array or tensor, the same on every rank, is placed
    first)."""
    axes = ("batch",) + (None,) * (np.ndim(v) - 1)
    if not hasattr(v, "placements"):
        mesh = current_mesh()
        v = place(torch.as_tensor(v).to(dev), mesh,
                  mesh_sharding(mesh, axes, current_rules() or DEFAULT_RULES))
    return constrain(v, axes)


def _micro(v: torch.Tensor, accum_steps: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum_steps``: rows ``i*mb:(i+1)*mb``, a
    ``DTensor`` one regathered over the batch axes first (the rows of one
    microbatch lie on a few data ranks) and split over them again."""
    mb = v.shape[0] // accum_steps
    axes = (None,) * v.dim()
    out = local_apply(lambda v: v.reshape((accum_steps, mb) + tuple(v.shape[1:]))[i],
                      (v,), (axes,), (axes,))
    return constrain(out, ("batch",) + axes[1:])


# ----------------------------------------------------------- int8 compression
def _quantize(g: torch.Tensor, absmax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with the scale of ``absmax`` (default: ``g``'s own);
    the reference quantizes a stacked leaf with one scale for all its
    layers, so a layer's tensor is given the leaf's absmax."""
    if absmax is None:
        absmax = torch.max(torch.abs(g))
    scale = absmax / 127.0 + 1e-12
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _accumulate_compressed(gsum, err, grads, acc_dt) -> None:
    """Add the int8 round trip of ``grads`` plus the carried error to
    ``gsum``, and keep the new error: per reference leaf, so the layers of
    one stacked leaf share its scale."""
    for group in reference_order(grads):
        full = {n: grads[n].float() + err[n] for n in group}
        absmax = torch.max(torch.stack([f.abs().max() for f in full.values()]))
        for n, f in full.items():
            deq = _dequantize(*_quantize(f, absmax))
            gsum[n].add_(deq.to(acc_dt))
            err[n] = f - deq


class _Phases:
    """The spans of one traced step: each phase runs from the previous
    boundary to the next (host clock), and on a CUDA device also between the
    timing events recorded there; ``close`` records the parent
    ``train.step``."""

    def __init__(self, tracer, vol, step: int, device):
        self.tracer, self.task, self.instance = tracer, vol.task, vol.instance
        self.step = step
        self.device = device if device.type == "cuda" else None
        self.ev0 = self.ev = self._event()
        self.t0 = self.t = time.monotonic()

    def _event(self):
        if self.device is None:
            return None
        return self.tracer.device_mark(self.device)

    def _record(self, name: str, t0: float, t1: float, ev0, ev1, **args) -> None:
        if self.device is None:
            self.tracer.record("train", name, self.task, self.instance, t0, t1,
                               step=self.step, **args)
        else:
            self.tracer.record_device("train", name, self.task, self.instance,
                                      t0, t1, self.device, ev0, ev1,
                                      step=self.step, **args)

    def mark(self, name: str, **args: Any) -> None:
        """End phase ``name`` here, with the counters ``args``; the next
        phase starts here."""
        ev = self._event()
        t = time.monotonic()
        self._record(name, self.t, t, self.ev, ev, **args)
        self.t, self.ev = t, ev

    def close(self) -> None:
        self._record("train.step", self.t0, self.t, self.ev0, self.ev)


def _optimizer_launches() -> int:
    """The fused AdamW kernels' launches so far (none on the CPU path)."""
    return sum(launch_counts(ADAMW_KERNELS).values())


def make_train_step(
    cfg,
    opt_cfg: Optional[AdamWConfig] = None,
    accum_steps: int = 1,
    compress_grads: bool = False,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Build train_step(state, batch) -> (new_state, metrics).

    batch leaves (tensors or host arrays) have leading dim = global_batch;
    with accum_steps > 1 the leading dim must divide into ``accum_steps``
    microbatches.  Metrics are 0-d float32 tensors: ``loss``, ``lr``,
    ``grad_norm``."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    fam = get_family(cfg)
    loss_fn = fam.loss_fn
    calls = 0     # the step's own count of its calls: the spans' ``step``

    def grads_of(model, batch, phases):
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, cfg, batch)
        if phases is not None:
            phases.mark("train.forward")
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), dict(zip(names, grads))

    def train_step(state: TrainState, batch: Dict[str, Any]):
        nonlocal calls
        calls += 1
        vol = current_vol()
        tracer = vol.tracer if vol is not None else None
        model = state.params
        dev = next(model.parameters()).device
        phases = None if tracer is None else _Phases(tracer, vol, calls, dev)
        sharded = _is_sharded(model)
        if sharded:
            batch = {k: _batch_leaf(v, dev) for k, v in batch.items()}
        else:
            batch = {k: torch.as_tensor(_local(v)).to(dev)
                     for k, v in batch.items()}

        if accum_steps == 1:
            loss, grads = grads_of(model, batch, phases)
            if phases is not None:
                phases.mark("train.backward")
        else:
            mb_rules = current_rules()
            if sharded:
                if (next(iter(batch.values())).shape[0] // accum_steps) % \
                        axis_size("batch"):
                    # a microbatch the batch axes do not split evenly is
                    # replicated over them, as make_cell does a small batch
                    mb_rules = mb_rules.with_(batch=None)
                with use_mesh(current_mesh(), mb_rules):
                    micro = [{k: _micro(v, accum_steps, i) for k, v in batch.items()}
                             for i in range(accum_steps)]
            else:
                micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()} for i in range(accum_steps)]
            # accumulate in the optimizer-state dtype, as the reference does
            acc_dt = getattr(torch, opt_cfg.state_dtype)
            gsum = {n: torch.zeros_like(p, dtype=acc_dt)
                    for n, p in model.named_parameters()}
            err = ({n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in model.named_parameters()}
                   if compress_grads else None)
            losses = []
            for mb in micro:
                with (use_mesh(current_mesh(), mb_rules) if sharded
                      else contextlib.nullcontext()):
                    l, g = grads_of(model, mb, phases)
                losses.append(l)
                with torch.no_grad():
                    if err is None:
                        for n, gg in g.items():
                            gsum[n].add_(gg.to(acc_dt))
                    else:
                        _accumulate_compressed(gsum, err, g, acc_dt)
                del g
                if phases is not None:    # the accumulation is backward's
                    phases.mark("train.backward")
            # in place, and the error buffer freed: at full width each is a
            # float32 copy of the parameters, and the update still needs the
            # moments' room
            err = None
            grads = {n: a.div_(accum_steps) for n, a in gsum.items()}
            loss = torch.mean(torch.stack(losses))

        # the reference's ZeRO hint: gradients to the parameter layout
        rules = current_rules()
        if sharded and rules is not None and rules.weight_gather:
            pspecs = fam.param_specs(cfg)
            grads = {n: constrain(g, pspecs[n]) for n, g in grads.items()}

        if phases is not None:
            before = _optimizer_launches()
        _, new_opt, om = adamw_update(model, grads, state.opt, opt_cfg)
        if phases is not None:
            phases.mark("train.optimizer", leaves=len(grads),
                        launches=_optimizer_launches() - before)
            phases.close()
        metrics = {"loss": loss, **om}
        return TrainState(model, new_opt, state.rng), metrics

    return train_step
