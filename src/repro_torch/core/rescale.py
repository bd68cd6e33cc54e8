"""Elastic rescale surgery: live M->N resize of a supervised consumer task.

This module is the driver-side executor behind ``RunSupervisor.lead(op)``:
by the time :func:`execute_rescale` runs, every live old instance of the
task has retired out of its callable (``RescaleInterrupt`` arrival protocol
in ``recovery.py``) and the caller is the single surgery leader.  The
surgery then performs, in order:

1. **Grace + quiesce** -- blocked producer ``offer``s on the retiring
   channels complete immediately (``rescale_release_producer``), then every
   feeding producer's ``serve_lock`` is taken so no serve can straddle the
   swap.  The lock order (grace first) matters: a producer parked inside
   ``offer`` *holds* its serve lock, so the grace release is what makes the
   lock acquirable.
2. **Snapshot** -- producer-side counters plus every step the new partition
   may need (retention ring + replay buffer + undelivered queue) are read
   from each retiring channel; sibling channels of one edge must agree on
   the producer counters (they are fan-out copies of the same serves).
   Payload futures are resolved here, outside any channel lock.
3. **Consistent cut** -- ``C = min`` over the old instances' newest durable
   checkpoint steps.  Each instance's step-``C`` container is re-cut:
   leaves declared in ``sharded.json`` are re-split M->N through
   ``reshard_blocks`` (the startup reshard machinery turned recovery
   feature); every other leaf must be a bitwise replica and is copied
   through.  The per-step ``seqs_*.json`` sidecar gives the delivered-seq
   floor: everything after it is replay.
4. **Rebuild** -- N fresh channels per inbound edge (new ``RedistSpec``
   partition, epoch bumped past every retired incarnation) adopt the
   producer counters verbatim and are preloaded with the replay steps,
   re-partitioned by reconstructing each step's *global* file from the M
   sibling slabs and running it through the new channel's own serve-path
   payload builder -- so a replayed delivery is byte-identical to a live
   one at the new size.
5. **Swap + seal** -- producer VOL outgoing lists, driver channel/VOL/
   recovery-context tables, the graph's ``task_count``/``nprocs``, the
   scheduler's channel list and the supervisor's are all repointed; then
   ``finish_rescale`` bumps the task generation (fencing zombies) and the
   driver spawns fresh threads for all N new instances.

In this package a redistributed step whose slabs are tensors is stitched
with torch on the slabs' device, so a replayed delivery is a tensor on the
same device as a live one; the checkpoint re-cut stays on the host, where
the containers are, and the new incarnation's ``restore`` puts its shard
back where its ``like`` lives.  The new instances' device groups are cut
from the old instances' devices.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.lockcheck import check_blocking, sched_point
from ..convert import numpy_from_tensor
from .channel import Channel
from .datamodel import Dataset, File, Group, is_device_array
from .recovery import (RecoveryContext, RescaleError, RescaleOp, edge_key,
                       reshard_blocks)
from .redistribute import RedistSpec
from .vol import VOL

__all__ = ["execute_rescale"]

# flatten-with-path key of a flat dict state: ``{"acc": ...}`` -> ``"['acc']"``
_FLAT_KEY_RE = re.compile(r"^\['(.+)'\]$")

_REDIST_ATTRS = ("redist_global_shape", "redist_box_starts")


# ---------------------------------------------------------------------------
# payload resolution + global-file reconstruction
# ---------------------------------------------------------------------------
def _resolve_items(ch: Channel, items: List[Tuple[str, Any, int, int, Any]]
                   ) -> Dict[int, File]:
    """Materialize a snapshot's items into {seq: File}.

    Future payloads resolve here -- *outside* any channel lock -- falling
    back to a synchronous re-prepare of the source file when the async prep
    errored or was cancelled (same idempotence contract as prep-retry)."""
    out: Dict[int, File] = {}
    for kind, payload, seq, _epoch, src in items:
        if kind == "future":
            try:
                check_blocking("future.result")
                (kind, payload), _nbytes = payload.result()
            except BaseException:
                if src is None:
                    raise
                (kind, payload), _nbytes = ch._prepare(src)
        if kind == "file":
            payload = File.load(payload)
        out[seq] = payload
    return out


def _copy_group_attrs(src: Group, dst: File) -> None:
    for name, child in src.children.items():
        if isinstance(child, Dataset):
            continue
        g = dst.require_group(child.path)
        g.attrs.update(child.attrs)
        _copy_group_attrs(child, dst)


def _reconstruct_global(siblings: List[File]) -> File:
    """Rebuild one served step's global file from the M per-instance slabs.

    Datasets shipped whole (fan-out, aligned fast path, scalars) graft as
    CoW views of sibling 0's copy.  Redistributed slabs carry their global
    shape and box origin as attrs; the global array is stitched from every
    sibling's slab (the old decomposition tiles it exactly) and the redist
    bookkeeping attrs are dropped -- the result is what the producer closed,
    ready for any new partition's payload builder.  Tensor slabs are
    stitched with torch on their device, host slabs with numpy."""
    base = siblings[0]
    out = File(base.filename)
    out.attrs.update(base.attrs)
    _copy_group_attrs(base, out)
    for ds in base.visit_datasets():
        if "redist_global_shape" not in ds.attrs:
            out.attach_view(ds)
            continue
        gshape = tuple(int(x) for x in ds.attrs["redist_global_shape"])
        src = ds.read_direct()
        if is_device_array(src):
            buf = torch.zeros(gshape, dtype=src.dtype, device=src.device)
        else:
            buf = np.zeros(gshape, dtype=ds.dtype)
        for sib in siblings:
            sds = sib.get(ds.path)
            if sds is None or 0 in sds.shape:
                continue
            starts = tuple(int(x) for x in sds.attrs["redist_box_starts"])
            slc = tuple(slice(s, s + n) for s, n in zip(starts, sds.shape))
            buf[slc] = sds.read_direct()
        v = out.create_dataset(ds.path, data=buf, copy=False)
        for k, val in ds.attrs.items():
            if k not in _REDIST_ATTRS:
                v.attrs[k] = val
    return out


# ---------------------------------------------------------------------------
# checkpoint re-cut
# ---------------------------------------------------------------------------
def _host(leaf: Any) -> np.ndarray:
    return numpy_from_tensor(leaf) if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def _write_json(directory: str, name: str, payload: Dict[str, Any]) -> None:
    tmp = os.path.join(directory, name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, os.path.join(directory, name))


def _recut_checkpoints(driver: Any, op: RescaleOp, gen_next: int
                       ) -> Tuple[Optional[int], Dict[str, int], List[str]]:
    """Pick the consistent cut C, re-split the step-C shards M->N, and save
    them into fresh per-generation directories.  C is the NEWEST step every
    old instance still holds (shard + seq sidecar) with agreeing consumed-seq
    floors: checkpoint GC (``keep=``) trims each instance's window
    independently, so when a stalled instance fell behind its live siblings
    the windows may no longer overlap -- then, or when some instance never
    checkpointed at all, C is None: fresh start with a full replay from the
    producers' retention rings.  Returns ``(C, per-edge delivered floors at
    C, new dirs)``."""
    from ..train.checkpoint import load_pytree_flat, save_pytree

    task, M, N = op.task, op.old_nslots, op.new_nslots
    new_dirs = [os.path.join(driver._ck_root, f"{task}_{j}__g{gen_next}")
                for j in range(N)]
    for d in new_dirs:
        os.makedirs(d, exist_ok=True)

    old_rcs = [driver._recovery_ctx[(task, i)] for i in range(M)]
    latests = [rc.latest_step() for rc in old_rcs]
    if any(l is None for l in latests):
        return None, {}, new_dirs

    def _held_steps(rc: Any) -> set:
        steps = set()
        for fn in os.listdir(rc.directory):
            m = re.match(r"^step_(\d{8})\.ckpt$", fn)
            if m is not None and os.path.exists(os.path.join(
                    rc.directory, f"seqs_{int(m.group(1)):08d}.json")):
                steps.add(int(m.group(1)))
        return steps

    common = set.intersection(*(_held_steps(rc) for rc in old_rcs))
    candidates = sorted((s for s in common if s <= min(latests)),
                        reverse=True)

    C: Optional[int] = None
    flats: List[Dict[str, Any]] = []
    floors: Optional[Dict[str, int]] = None
    for cand in candidates:
        flats, floors, ok = [], None, True
        for rc in old_rcs:
            flats.append(load_pytree_flat(
                os.path.join(rc.directory, f"step_{cand:08d}.ckpt")))
            with open(os.path.join(rc.directory,
                                   f"seqs_{cand:08d}.json")) as f:
                fl = {k: int(v)
                      for k, v in json.load(f).get("seqs", {}).items()}
            if floors is None:
                floors = fl
            elif floors != fl:
                # the per-step loops drifted at this step; an older common
                # step may still carry an agreeing replay floor
                ok = False
                break
        if ok:
            C = cand
            break
    if C is None:
        return None, {}, new_dirs

    sharded: Dict[str, int] = {}
    spath = os.path.join(old_rcs[0].directory, "sharded.json")
    if os.path.exists(spath):
        with open(spath) as f:
            sharded = {k: int(v) for k, v in json.load(f).items()}

    keys0 = set(flats[0])
    for rc, fl in zip(old_rcs[1:], flats[1:]):
        if set(fl) != keys0:
            raise RescaleError(
                f"task {task!r}: checkpoint leaf keys differ across "
                f"instances ({sorted(keys0)} vs {sorted(fl)})")
    user_keys: Dict[str, str] = {}
    for fk in sorted(keys0):
        m = _FLAT_KEY_RE.match(fk)
        if m is None:
            raise RescaleError(
                f"task {task!r}: rescale requires a flat dict checkpoint "
                f"state (top-level string keys only), got leaf {fk!r}")
        user_keys[m.group(1)] = fk

    # a bfloat16 leaf loads as a CPU tensor and is re-cut as its int16 bit
    # pattern; it is saved back as a tensor so its container keeps the mark
    new_states: List[Dict[str, Any]] = [{} for _ in range(N)]
    for uk, fk in user_keys.items():
        if uk in sharded:
            cut = reshard_blocks([fl[fk] for fl in flats], N,
                                 axis=sharded[uk])
            bf16 = isinstance(flats[0][fk], torch.Tensor)
            for j in range(N):
                part = np.ascontiguousarray(cut[j])
                new_states[j][uk] = (torch.from_numpy(part).view(torch.bfloat16)
                                     if bf16 else part)
        else:
            ref = flats[0][fk]
            for rc, fl in zip(old_rcs[1:], flats[1:]):
                if not np.array_equal(_host(fl[fk]), _host(ref)):
                    raise RescaleError(
                        f"task {task!r}: non-sharded checkpoint leaf {uk!r} "
                        f"differs between instances 0 and {rc.instance} -- "
                        f"declare it in sharded_axes or keep it a replica")
            for j in range(N):
                new_states[j][uk] = ref

    for j, d in enumerate(new_dirs):
        save_pytree(new_states[j], os.path.join(d, f"step_{C:08d}.ckpt"))
        _write_json(d, f"seqs_{C:08d}.json",
                    {"step": C, "seqs": dict(floors or {})})
        if sharded:
            _write_json(d, "sharded.json", dict(sharded))
        # LATEST last: a crash mid-recut leaves no readable checkpoint, and
        # the new incarnation starts fresh instead of reading a torn cut
        tmp = os.path.join(d, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(C))
        os.replace(tmp, os.path.join(d, "LATEST"))
    return C, dict(floors or {}), new_dirs


def _regroup_devices(old_groups: List[Optional[List[Any]]], n: int
                     ) -> List[Optional[List[Any]]]:
    """The N new instances' device groups: the old instances' devices, in
    order and without repeats, cut into N contiguous groups -- or one device
    each, in turn, when there are fewer devices than instances (on one GPU
    every instance keeps that GPU)."""
    pool: List[Any] = []
    for g in old_groups:
        for d in g or ():
            if d not in pool:
                pool.append(d)
    if not pool:
        return [None] * n
    if len(pool) < n:
        return [[pool[j % len(pool)]] for j in range(n)]
    bounds = [len(pool) * j // n for j in range(n + 1)]
    return [pool[bounds[j]:bounds[j + 1]] for j in range(n)]


# ---------------------------------------------------------------------------
# the surgery
# ---------------------------------------------------------------------------
def execute_rescale(driver: Any, op: RescaleOp) -> None:
    """Perform the M->N resize of ``op.task`` on a quiesced driver.

    Caller contract (enforced by ``RunSupervisor``): every live old
    instance has arrived (retired out of its callable); exactly one thread
    -- the leader -- calls this."""
    sup = driver._run_supervisor
    if sup is None:
        raise RescaleError(f"task {op.task!r}: no run in progress")
    try:
        _execute(driver, sup, op)
    except BaseException as e:
        sup.fail_rescale(op, e)
        raise


def _execute(driver: Any, sup: Any, op: RescaleOp) -> None:
    import time as _time

    task, M, N = op.task, op.old_nslots, op.new_nslots
    t = driver.graph.tasks[task]
    gen_next = sup.generation(task) + 1
    tr = sup.tracer  # surgery stages report as rescale spans when traced

    def _stage(name: str, t0: float) -> float:
        now = _time.monotonic()
        if tr is not None:
            tr.record("rescale", f"rescale.{name}", task, -1, t0, now,
                      old=M, new=N)
        return now

    t_stage = _time.monotonic()

    old_chs = [ch for ch in driver.channels if ch.consumer[0] == task]
    old_by_edge: Dict[str, List[Channel]] = {}
    for ch in old_chs:
        old_by_edge.setdefault(edge_key(ch.name), []).append(ch)
    for chs in old_by_edge.values():
        chs.sort(key=lambda c: c.consumer[1])
        if len(chs) != M or [c.consumer[1] for c in chs] != list(range(M)):
            raise RescaleError(
                f"task {task!r}: edge {edge_key(chs[0].name)!r} does not "
                f"have one channel per old instance (found "
                f"{[c.consumer[1] for c in chs]}, expected 0..{M - 1})")

    # 1. grace: complete any blocked producer offer on the retiring edges,
    # THEN take the producers' serve locks -- a producer parked in offer
    # holds its serve lock, so this order is what makes them acquirable.
    for ch in old_chs:
        ch.rescale_release_producer()
    # the grace-to-lock window: producers drain out of their rendezvous
    # while the leader has not yet taken the serve locks
    sched_point("rescale.grace_to_lock", key=("rescale", task))
    producers = sorted({ch.producer for ch in old_chs})
    held: List[Any] = []
    try:
        for p in producers:
            lk = driver.vols[p].serve_lock
            lk.acquire()
            held.append(lk)
        t_stage = _stage("grace", t_stage)

        # 2. snapshot counters + every re-cuttable step; siblings of one
        # edge are fan-out copies of the same serves, so their producer
        # counters must agree or the retiring edges are not re-cuttable.
        snaps: Dict[str, List[Dict[str, Any]]] = {}
        for key, chs in old_by_edge.items():
            per = [ch.rescale_snapshot() for ch in chs]
            ref = per[0]
            for s in per[1:]:
                for fld in ("serve_seq", "close_count", "done"):
                    if s[fld] != ref[fld]:
                        raise RescaleError(
                            f"task {task!r}: sibling channels of edge "
                            f"{key!r} disagree on producer counter {fld} "
                            f"({ref[fld]} vs {s[fld]})")
            snaps[key] = per
        payloads: Dict[str, List[Dict[int, File]]] = {
            key: [_resolve_items(ch, s["items"])
                  for ch, s in zip(old_by_edge[key], snaps[key])]
            for key in old_by_edge
        }
        t_stage = _stage("snapshot", t_stage)

        # 3. consistent cut + checkpoint re-cut (M shards -> N shards)
        cut_step, floors, new_dirs = _recut_checkpoints(driver, op, gen_next)
        t_stage = _stage("recut", t_stage)

        # 4. rebuild: N fresh channels per inbound edge, counters adopted
        # verbatim, replay steps re-partitioned through each new channel's
        # own payload builder (byte-identical to a live serve at size N)
        new_np = op.new_nprocs
        new_io = t.nwriters if t.nwriters is not None else new_np
        new_chs: List[Channel] = []
        new_by_inst: List[List[Channel]] = [[] for _ in range(N)]
        for edge in driver.graph.producers_of(task):
            key = f"{edge.producer}->{task}:{edge.filename_pattern}"
            if key not in old_by_edge:
                raise RescaleError(
                    f"task {task!r}: no retiring channels for inbound edge "
                    f"{key!r}")
            pi = old_by_edge[key][0].producer[1]
            snap0 = snaps[key][0]
            floor = int(floors.get(key, 0))
            serve_seq = int(snap0["serve_seq"])
            sib_maps = payloads[key]
            replayed: Dict[int, File] = {}
            for seq in range(floor + 1, serve_seq + 1):
                sibs = []
                for m in sib_maps:
                    if seq not in m:
                        raise RescaleError(
                            f"task {task!r}: edge {key!r} lost served step "
                            f"seq={seq} from the retention window before "
                            f"the rescale -- checkpoint more often or raise "
                            f"the retention cap")
                    sibs.append(m[seq])
                replayed[seq] = _reconstruct_global(sibs)
            for j in range(N):
                redist = None
                if edge.redistribute:
                    redist = RedistSpec(axis=edge.redist_axis, nslots=N,
                                        slot=j, nranks=new_io)
                ch = Channel(
                    name=f"{edge.producer}[{pi}]->{task}[{j}]:"
                         f"{edge.filename_pattern}",
                    producer=(edge.producer, pi),
                    consumer=(task, j),
                    filename_pattern=edge.filename_pattern,
                    dset_patterns=edge.dset_patterns,
                    mode=edge.mode,
                    io_freq=edge.io_freq,
                    spill_dir=driver.spill_dir,
                    record_events=driver.record_events,
                    queue_depth=edge.queue_depth,
                    zero_copy=driver.zero_copy,
                    redistribute=redist,
                    prefetch=edge.prefetch,
                    weight=edge.weight,
                    autotune=edge.autotune,
                )
                ch.rescale_adopt(
                    serve_seq=serve_seq,
                    acked_seq=int(snap0["acked_seq"]),
                    close_count=int(snap0["close_count"]),
                    acked_close_count=int(snap0["acked_close_count"]),
                    done=bool(snap0["done"]),
                    epoch=sup.epoch(task, j) + 1,
                    delivered_floor=floor,
                )
                ch.set_supervisor(sup)
                ch.set_tracer(tr)
                ch.set_prep_retry(True)
                ch.set_replay(True)
                ch.set_retention(True)
                if driver._run_pool is not None:
                    ch.set_prefetch_pool(driver._run_pool)
                for seq in range(floor + 1, serve_seq + 1):
                    (kind, sub), _nb = ch._prepare(replayed[seq])
                    assert kind == "memory", kind
                    ch.rescale_preload(sub, seq)
                new_chs.append(ch)
                new_by_inst[j].append(ch)
        t_stage = _stage("rebuild", t_stage)

        # 5. swap, everywhere, while the producers are still locked out
        dead = {id(c) for c in old_chs}
        sched_wired = driver.vols[(task, 0)].scheduler \
            if (task, 0) in driver.vols else None
        for p in producers:
            pvol = driver.vols[p]
            pvol.outgoing = [c for c in pvol.outgoing
                             if id(c) not in dead] + \
                            [c for c in new_chs if c.producer == p]
            prc = driver._recovery_ctx.get(p)
            if prc is not None:
                prc.outgoing = [c for c in prc.outgoing
                                if id(c) not in dead] + \
                               [c for c in new_chs if c.producer == p]
        for i in range(M):
            rc_old = driver._recovery_ctx.get((task, i))
            if rc_old is not None:
                rc_old.superseded = True
        groups = _regroup_devices(
            [driver.device_groups.get((task, i)) for i in range(M)], N)
        for j in range(N, M):
            driver._recovery_ctx.pop((task, j), None)
            driver.vols.pop((task, j), None)
            driver.device_groups.pop((task, j), None)
        for j in range(N):
            driver.device_groups[(task, j)] = groups[j]
        for j in range(N):
            vol = VOL(task, instance=j, nprocs=new_np, io_procs=new_io)
            vol.incoming.extend(new_by_inst[j])
            for ch in new_by_inst[j]:
                if ch.mode == "memory":
                    vol.set_memory(ch.filename_pattern)
                else:
                    vol.set_file(ch.filename_pattern)
            vol.scheduler = sched_wired
            vol.supervisor = sup
            vol.tracer = tr
            driver.vols[(task, j)] = vol
            driver._recovery_ctx[(task, j)] = RecoveryContext(
                task, j, new_dirs[j], incoming=new_by_inst[j], outgoing=[])
        t.task_count = N
        t.nprocs = new_np
        # rebind (don't mutate): concurrent readers iterate a consistent list
        updated = [c for c in driver.channels if id(c) not in dead] + new_chs
        driver.channels = updated
        if driver._run_report is not None:
            driver._run_report.channels = updated
        sched = driver._sched_runtime
        if sched is not None:
            sched.channels = [c for c in sched.channels
                              if id(c) not in dead] + new_chs
        sup.replace_channels(old_chs, new_chs)
        t_stage = _stage("swap", t_stage)
    finally:
        for lk in held:
            lk.release()

    # 6. seal: bump the generation (fencing every pre-rescale incarnation),
    # record the event, and hand the new instances to fresh threads
    ev = sup.finish_rescale(op, cut_step if cut_step is not None else -1)
    if driver._run_report is not None:
        driver._run_report.rescales.append(ev.as_dict())
    sched = driver._sched_runtime
    if sched is not None:
        sched.notify_rescale(task, M, N, op.old_nprocs, new_np, op.trigger,
                             ev.cut_step, ev.latency_s, op.reason)
    gen = sup.generation(task)
    for j in range(N):
        driver._spawn_extra(task, j, gen)
