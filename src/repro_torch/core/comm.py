"""Restricted-world communicators -- the PMPI-partitioning analogue.

Wilkins runs all tasks as one SPMD job and presents each task with a
*restricted* MPI_COMM_WORLD so task codes can be written as if they were the
only program running (paper §3.5).  Here the resources being
partitioned are *devices* (and logical ranks for the host-side runtime): the
driver slices the global device list into disjoint per-task groups sized
proportionally to ``nprocs`` and hands every task a ``TaskComm`` that exposes

* ``size``/``rank``       -- the logical process view (nprocs from YAML),
* ``io_procs``            -- the subset-of-writers count (``nwriters`` field),
* ``devices`` / ``device`` / ``mesh()`` -- the task's restricted group of
  ``torch.device``s; task code allocates its tensors on ``device``.

Task code obtains its communicator with ``comm.world()`` -- which returns the
restricted world inside a workflow and a trivial single-rank world standalone,
so the code is, again, identical in both settings.

``TaskComm.reshard`` is the user-facing face of the M->N redistribution
subsystem (paper §3.4): the driver wires each task's declared ``RedistSpec``s
onto the communicator, so task code reshards a device array / numpy array /
received Dataset into its per-rank blocks with ONE call -- no plan objects,
no executor choice.  Tensors (any rank, global extent or a received slab)
go through the pack kernels -- rank>2 plans flatten
their non-decomposed axes onto the 2-D kernels; host buffers and genuinely
cross-axis N-D decompositions take the numpy scatter executors.  Plans come
from the process-wide ``PlanCache``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["TaskComm", "world", "push_comm", "pop_comm"]

_tls = threading.local()


@dataclass
class TaskComm:
    task: str = "__standalone__"
    instance: int = 0
    rank: int = 0
    size: int = 1
    io_procs: int = 1
    rank_offset: int = 0          # position in the global SPMD rank space
    devices: Optional[List[Any]] = None   # restricted torch.device group
    mesh_axes: Tuple[str, ...] = ("data",)
    extras: dict = field(default_factory=dict)
    # filename_pattern -> RedistSpec, wired by the driver from the task's
    # redistributing ports (consumer inports win over outports it feeds)
    redist_specs: Dict[str, Any] = field(default_factory=dict)
    # per-run SchedulerRuntime (driver-wired): lets task code mark explicit
    # step boundaries for the depth autotuner via ``comm.step()`` -- useful
    # for compute loops that do no file I/O between timesteps
    scheduler: Any = None
    # per-instance RecoveryContext (driver-wired when the run has a
    # supervisor): the checkpoint/restore surface below routes through it
    recovery: Any = None
    # the RunSupervisor itself (driver-wired alongside ``recovery``): the
    # programmatic rescale trigger below routes through it
    supervisor: Any = None
    # per-run SpanRecorder (driver-wired on traced runs): checkpoint /
    # restore / reshard below report themselves as spans when present
    tracer: Any = None

    def is_io_proc(self, rank: Optional[int] = None) -> bool:
        r = self.rank if rank is None else rank
        return r < self.io_procs

    @property
    def device(self):
        """The first device of this task's group: where its tensors live.
        Standalone (no group wired) that is ``cuda:0``."""
        return self._devices()[0]

    def _devices(self) -> List[Any]:
        if self.devices is not None:
            return list(self.devices)
        import torch

        return [torch.device("cuda", 0)]

    def mesh(self, shape: Optional[Tuple[int, ...]] = None,
             axes: Optional[Tuple[str, ...]] = None):
        """A numpy object array of this task's ``torch.device``s in
        ``shape`` (the device grid a mesh would be built over).

        ``shape`` must fit inside the restricted world: asking for more
        devices than the driver granted this task raises a clear
        ``ValueError`` (instead of an opaque numpy reshape error) -- the fix
        is a bigger ``nprocs`` share in the workflow YAML, not a code change.
        ``axes`` is accepted for signature parity and names nothing here.
        """
        import numpy as np

        devs = self._devices()
        if shape is None:
            shape = (len(devs),)
        shape = tuple(int(s) for s in shape)
        need = int(np.prod(shape)) if shape else 1
        if need > len(devs):
            raise ValueError(
                f"task {self.task!r}: mesh shape {shape} needs {need} "
                f"devices but this task's restricted device group holds "
                f"only {len(devs)}; grow the task's nprocs share (or shrink "
                f"the mesh)")
        arr = np.empty(need, dtype=object)
        arr[:] = devs[:need]
        return arr.reshape(shape)

    def barrier(self) -> None:  # single-process runtime: no-op
        pass

    def step(self) -> None:
        """Mark an explicit step boundary for the runtime scheduler.

        File closes (producers) and intercepted opens (consumers) already
        count as step events; a task whose timestep loop does neither can
        call this so the depth autotuner / telemetry sampler still tick at
        its cadence.  No-op standalone (no workflow scheduler wired)."""
        if self.scheduler is not None:
            self.scheduler.notify_step("comm_step")
        if self.supervisor is not None:
            # an explicit step is proof of life for the stall watchdog too
            self.supervisor.heartbeat(self.task, self.instance)

    # ------------------------------------------------- checkpoint / restore
    @property
    def attempt(self) -> int:
        """Which incarnation of this task instance is running (0 = first
        launch; restarts increment).  0 standalone."""
        return self.recovery.attempt if self.recovery is not None else 0

    @property
    def epoch(self) -> int:
        """The channel epoch this incarnation serves/receives under."""
        return self.recovery.epoch if self.recovery is not None else 0

    def checkpoint(self, state: Any, step: Optional[int] = None,
                   block: bool = True,
                   sharded_axes: Optional[Dict[str, int]] = None
                   ) -> Optional[int]:
        """Snapshot ``state`` (any pytree) for crash recovery.

        Routed through the run's ``AsyncCheckpointer`` (atomic container +
        LATEST pointer under the run's spill dir) and then *acks* this
        instance's channels: everything served/delivered so far is durable,
        so a restart replays only what came after this call.  Returns the
        checkpoint step, or ``None`` standalone (no recovery wired) -- task
        code is identical in and out of a workflow.

        ``sharded_axes`` maps top-level keys of a flat dict ``state`` to the
        axis along which that leaf is this instance's shard of a global
        array.  Required for tasks under an elastic ``rescale:`` policy: a
        rescale re-cuts those leaves across the new instance count and
        asserts every other leaf is replicated.

        ``block=True`` (default) makes the save durable before acking; see
        DESIGN.md for the cadence/overhead trade."""
        if self.recovery is None:
            return None
        if self.tracer is None:
            return self.recovery.checkpoint(state, step=step, block=block,
                                            sharded_axes=sharded_axes)
        t0 = time.monotonic()
        out = self.recovery.checkpoint(state, step=step, block=block,
                                       sharded_axes=sharded_axes)
        self.tracer.record("checkpoint", "ckpt.save", self.task,
                           self.instance, t0, time.monotonic(), step=out,
                           blocking=block)
        return out

    def rescale(self, task: Optional[str] = None, *,
                nslots: Optional[int] = None,
                nprocs: Optional[int] = None,
                reason: str = "") -> Any:
        """Programmatic elastic-rescale trigger (``RunSupervisor.rescale``).

        Requests that ``task`` (default: this task) be brought down and
        relaunched at a different instance count (``nslots``) and/or logical
        rank count (``nprocs``), replaying undelivered steps into the
        re-partitioned consumers.  Returns the ``RescaleOp`` handle (its
        ``done`` event fires when the surgery completes), or ``None``
        standalone."""
        if self.supervisor is None:
            return None
        return self.supervisor.rescale(task or self.task, nslots=nslots,
                                       nprocs=nprocs, reason=reason)

    def restore(self, like: Any) -> Optional[Tuple[int, Any]]:
        """(step, state) from this instance's newest checkpoint, or ``None``
        on a fresh start (including standalone).  Call it first thing in the
        task function; a restarted incarnation resumes instead of redoing
        work.  ``like`` supplies the pytree structure/shapes (shape-checked
        on load)."""
        if self.recovery is None:
            return None
        if self.tracer is None:
            return self.recovery.restore(like)
        t0 = time.monotonic()
        out = self.recovery.restore(like)
        self.tracer.record("checkpoint", "ckpt.restore", self.task,
                           self.instance, t0, time.monotonic(),
                           step=out[0] if out is not None else None,
                           fresh=out is None)
        return out

    # ------------------------------------------------------------- reshard
    def resolve_redist_spec(self, spec: Any = None, port: Optional[str] = None):
        """The ``RedistSpec`` governing this task's reshards.

        Explicit ``spec`` wins; else ``port`` names the filename pattern of a
        wired redistributing port; else the task must have exactly one
        distinct spec wired by the driver."""
        if spec is not None:
            return spec
        if port is not None:
            try:
                return self.redist_specs[port]
            except KeyError:
                raise ValueError(
                    f"task {self.task!r} has no RedistSpec for port {port!r}; "
                    f"wired ports: {sorted(self.redist_specs)}") from None
        distinct = set(self.redist_specs.values())
        if len(distinct) == 1:
            return next(iter(distinct))
        if not distinct:
            raise ValueError(
                f"task {self.task!r} has no RedistSpec wired; declare "
                f"`redistribute:` on a port in the workflow YAML or pass spec=")
        raise ValueError(
            f"task {self.task!r} has {len(distinct)} distinct RedistSpecs "
            f"(ports {sorted(self.redist_specs)}); pass port= or spec=")

    def reshard(self, data, spec: Any = None, *, port: Optional[str] = None,
                src: Optional[Sequence[Any]] = None, ranks: Any = "mine",
                tile_rows: int = 8, prefer: str = "auto") -> List[Any]:
        """Reshard an array (or received Dataset) into per-rank blocks.

        The one-call face of the M->N subsystem: resolves the task's
        ``RedistSpec`` (see ``resolve_redist_spec``), pulls the
        ``CompiledPlan`` through the process-wide ``PlanCache``, and picks
        the executor -- the pack kernels for tensors whose plan lowers to
        row/column tiles, the numpy scatter executors otherwise.  Task code
        never touches plan objects.

        Parameters
        ----------
        data:   a ``torch.Tensor`` / ``np.ndarray`` holding the GLOBAL index
                space, or a ``datamodel.Dataset`` -- either a producer-side
                dataset (its ``ownership`` becomes the src decomposition) or
                a consumer-side slab received over a redistributing channel
                (recognised by its ``redist_*`` attrs; scatter reads straight
                from the slab, no global buffer is ever stitched).
        spec/port: see ``resolve_redist_spec``.
        src:    explicit src decomposition (list of (starts, shape) boxes)
                for raw arrays; default one global block.
        ranks:  ``"mine"`` (this instance's logical ranks -- the default),
                ``"all"`` (every dst rank of the full decomposition), or an
                explicit iterable of dst rank ids.
        tile_rows: pack-kernel tile extent along the decomposed axis.
        prefer: ``"auto"`` | ``"pack"`` (raise if the kernel path cannot
                serve) | ``"numpy"``.  Under ``"auto"`` a tensor off the
                CPU that the kernels cannot serve raises too: only
                ``"numpy"`` copies device data to the host.

        Returns the per-rank block list aligned to ``ranks`` (tensors on the
        tensor's device on the pack path, numpy arrays on the scatter path).

        Executor dispatch: the pack kernels serve any tensor (a
        ``torch.Tensor``, or a Dataset backed by one) whose plan is
        decomposed along a single axis -- any rank
        (rank>2 plans flatten onto the 2-D kernels, see
        ``redistribute.PackGeometry``), over the global extent OR a received
        slab (gathers then run in slab-local source coordinates).  Only
        host-resident data and genuinely cross-axis N-D decompositions take
        the numpy scatter executors; a device tensor does so only under
        ``prefer="numpy"``.
        """
        import numpy as np
        import torch

        from ..convert import numpy_from_tensor
        from .datamodel import Dataset
        from .redistribute import execute_pack_torch_all, intersect, plan_cache

        if prefer not in ("auto", "pack", "numpy"):
            raise ValueError(f"prefer must be auto|pack|numpy, got {prefer!r}")
        rspec = self.resolve_redist_spec(spec, port)

        slab_box = None
        if isinstance(data, Dataset):
            arr = data.read_direct()
            if "redist_box_starts" in data.attrs:
                # a received slab: its attrs carry the global frame
                gshape = tuple(int(s) for s in data.attrs["redist_global_shape"])
                slab_box = (tuple(int(s) for s in data.attrs["redist_box_starts"]),
                            tuple(arr.shape))
                src_boxes = [slab_box]
            elif data.ownership is not None and data.ownership.blocks:
                gshape = tuple(arr.shape)
                src_boxes = [data.ownership.blocks[r]
                             for r in sorted(data.ownership.blocks)]
            else:
                gshape = tuple(arr.shape)
                src_boxes = [((0,) * arr.ndim, gshape)]
        else:
            arr = data
            gshape = tuple(int(s) for s in arr.shape)
            src_boxes = ([(tuple(s), tuple(sh)) for s, sh in src]
                         if src is not None else [((0,) * len(gshape), gshape)])

        dst, _ = rspec.dst_boxes(gshape)
        if ranks == "mine":
            if rspec.slot < 0:
                raise ValueError(
                    f"task {self.task!r} is a PRODUCER for this "
                    f"redistributing port -- it has no 'mine' in the "
                    f"consumer decomposition; pass ranks=\"all\", explicit "
                    f"rank ids, or an explicit spec")
            wanted = list(rspec.my_ranks())
        elif ranks == "all":
            wanted = list(range(len(dst)))
        else:
            wanted = [int(r) for r in ranks]
        bad = [r for r in wanted if not 0 <= r < len(dst)]
        if bad:
            raise ValueError(f"dst ranks {bad} out of range for the "
                             f"{len(dst)}-block decomposition of {rspec}")
        pc = plan_cache()
        hits0 = pc.hits  # plan-cache verdict for the reshard span (traced
        cache = None     # runs only; racy across threads, advisory only)
        plan = pc.get(src_boxes, dst, gshape, arr.dtype)
        if self.tracer is not None:
            cache = "hit" if pc.hits > hits0 else "miss"

        if slab_box is not None:
            # an instance reshards what it was shipped: every wanted dst box
            # must sit inside the received slab (kernel and numpy path alike)
            for r in wanted:
                if intersect(dst[r], slab_box) != dst[r]:
                    raise ValueError(
                        f"dst rank {r} block {dst[r]} is not covered by the "
                        f"received slab {slab_box}; reshard the slab only "
                        f"onto ranks {list(rspec.my_ranks())}")

        # Probe the READ BUFFER, not the wrapper: a Dataset backed by a
        # tensor reshards on the kernel path exactly like a raw tensor.
        is_tensor = prefer != "numpy" and isinstance(arr, torch.Tensor)
        geom = plan.pack_geometry
        slab_pack_ok = slab_box is None or (
            geom is not None and geom.covers_slab(slab_box, gshape))
        expect_shape = plan.shape if slab_box is None else tuple(slab_box[1])
        can_pack = (is_tensor and geom is not None and slab_pack_ok
                    and tuple(arr.shape) == expect_shape)
        # a device tensor never moves to the host unless the caller asks
        on_device = is_tensor and arr.device.type != "cpu"
        if not can_pack and (prefer == "pack" or on_device):
            raise ValueError(
                "pack-kernel path unavailable: needs a tensor (or a "
                "tensor-backed Dataset) over the "
                "global extent or a received slab, and a single-axis "
                f"lowerable plan (got type={type(data).__name__}, "
                f"buffer={type(arr).__name__}, shape={tuple(arr.shape)}, "
                f"pack_mode={plan.pack_mode!r}, slab={slab_box!r})"
                + ("; pass prefer=\"numpy\" to reshard a host copy of "
                   f"this {arr.device} tensor" if on_device else ""))
        from .datamodel import transport_stats
        transport_stats().record_reshard(pack=can_pack)
        tr = self.tracer
        t0 = time.monotonic()
        if can_pack:
            out = execute_pack_torch_all(plan, arr, tile_rows=tile_rows,
                                         slab_box=slab_box, ranks=wanted)
        else:
            np_arr = (numpy_from_tensor(arr) if isinstance(arr, torch.Tensor)
                      else np.asarray(arr))
            if slab_box is not None:
                # scatter straight out of the slab (src_boxes == [slab_box])
                out = plan.execute([np_arr], ranks=wanted)
            else:
                out = plan.execute_global(np_arr, ranks=wanted)
        if tr is not None:
            tr.record("reshard",
                      "reshard.pack" if can_pack else "reshard.numpy",
                      self.task, self.instance, t0, time.monotonic(),
                      bytes=int(arr.nbytes), cache=cache,
                      ranks=len(wanted))
        return out


def world() -> TaskComm:
    """The task's restricted world (or a standalone single-rank world)."""
    stack = getattr(_tls, "comm_stack", None)
    if stack and stack[-1] is not None:
        return stack[-1]
    return TaskComm()


def push_comm(c: Optional[TaskComm]) -> None:
    if not hasattr(_tls, "comm_stack"):
        _tls.comm_stack = []
    _tls.comm_stack.append(c)


def pop_comm() -> None:
    _tls.comm_stack.pop()
