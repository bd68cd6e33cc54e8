"""The explorable-scenario corpus: small fixed workflows over REAL core
objects (``Channel``, ``Dataset``, ``ResizableSemaphore``), each asserting
its protocol invariant inside the thread bodies.

These are the *clean* scenarios: bounded exploration must complete with
zero WLK3xx findings (the CI ``explore`` job and
``tests/test_torch_explore.py`` gate exactly that).  The seeded-race
corpus -- the same shapes with the historical bugs re-introduced -- lives in
``tests/analysis_fixtures/races_torch/``.

Each entry in :data:`CORPUS` is a *builder* of one argument, the device
the payloads live on, returning the ``[(name, fn), ...]`` thread bodies
closed over freshly constructed shared state, so every enumerated schedule
starts from an identical world.  :func:`build_scenario` binds the device
(``cuda:0`` unless the caller asks for another) and hands back the
zero-argument builder the explorer takes.

The channel payloads are ``torch.int32`` tensors adopted in place
(``copy=False``) on that device; a scenario keeps every payload it made
referenced until the scenario itself is dropped, so the caching allocator
cannot hand a freed payload's address to the next one within a run (the
race detector keys a buffer by its address, and a reused address would
change the dependence relation between runs and between devices).
Builders keep prefetch OFF (``prefetch=0`` is the Channel default without
a RedistSpec): pool workers are daemon threads the controller does not
manage, and the corpus targets the *protocol* interleavings, not the
executor.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .. import lockcheck

__all__ = ["CORPUS", "build_scenario", "names"]

_Threads = Sequence[Tuple[str, Callable[[], None]]]


def _mk_channel(io_freq: int = 1, queue_depth: int = 1):
    from ...core.channel import Channel
    return Channel(
        name="p[0]->c[0]:out.h5",
        producer=("p", 0),
        consumer=("c", 0),
        filename_pattern="out.h5",
        dset_patterns=["/data"],
        io_freq=io_freq,
        queue_depth=queue_depth,
        prefetch=0,
        record_events=False,
    )


def _payloads(device: torch.device):
    """A payload factory for one scenario: ``make(step)`` is a File whose
    ``/data`` adopts ``torch.full((4,), step)`` on ``device``.  Every tensor
    it made stays referenced by the factory (see the module docstring)."""
    from ...core.datamodel import File
    keep: List[torch.Tensor] = []

    def make(step: int):
        t = torch.full((4,), step, dtype=torch.int32, device=device)
        keep.append(t)
        f = File("out.h5")
        f.create_dataset("/data", data=t, copy=False)
        return f

    return make


def _payload_value(f) -> int:
    return int(f["/data"][0])


# ---------------------------------------------------------------------------
# scenario builders
# ---------------------------------------------------------------------------
def rendezvous_depth1(device: torch.device) -> _Threads:
    """Depth-1 rendezvous (``io_freq: all``): in-order exactly-once
    delivery of 3 steps, then a clean producer-done."""
    _mk_file = _payloads(device)
    ch = _mk_channel(io_freq=1, queue_depth=1)
    got: List[int] = []

    def producer():
        for step in range(3):
            assert ch.offer(_mk_file(step)), f"serve of step {step} refused"
        ch.finish()

    def consumer():
        while True:
            f = ch.get()
            if f is None:
                break
            got.append(_payload_value(f))
        assert got == [0, 1, 2], f"lost/duplicated/reordered delivery: {got}"

    return [("producer", producer), ("consumer", consumer)]


def latest_fanin(device: torch.device) -> _Threads:
    """``latest`` flow control: serves happen only into a waiting consumer,
    so whatever arrives is fresh -- delivered steps must be strictly
    increasing and nothing may deadlock, on EVERY schedule (whether the
    producer saw the waiter or skipped is schedule-dependent by design)."""
    _mk_file = _payloads(device)
    ch = _mk_channel(io_freq=-1, queue_depth=1)
    got: List[int] = []

    def producer():
        for step in range(3):
            ch.offer(_mk_file(step))
        ch.finish()

    def consumer():
        while True:
            f = ch.get()
            if f is None:
                break
            got.append(_payload_value(f))
        assert got == sorted(set(got)), \
            f"`latest` delivered stale or duplicate steps: {got}"
        assert all(0 <= s <= 2 for s in got), f"unknown step in {got}"

    return [("producer", producer), ("consumer", consumer)]


def crash_replay(device: torch.device) -> _Threads:
    """Producer crash replay: quarantine rewinds the serve counters
    to the last ack and the restarted incarnation re-serves; the seq-dedup
    watermark must give the consumer each step exactly once, no matter how
    far it had drained before the crash."""
    _mk_file = _payloads(device)
    ch = _mk_channel(io_freq=1, queue_depth=4)
    got: List[int] = []

    def producer():
        for step in (0, 1):
            ch.offer(_mk_file(step))
        # crash here: nothing acked, so the restart replays from step 0.
        # Depending on the schedule the consumer drained 0, 1, or 2 items
        # already -- the dedup watermark must absorb every case.
        ch.quarantine_producer(epoch=1)
        for step in (0, 1, 2):
            ch.offer(_mk_file(step))
        ch.finish()

    def consumer():
        while True:
            f = ch.get()
            if f is None:
                break
            got.append(_payload_value(f))
        assert got == [0, 1, 2], \
            f"replay broke exactly-once delivery: {got}"

    return [("producer", producer), ("consumer", consumer)]


def rescale_window(device: torch.device) -> _Threads:
    """The rescale surgery window: grace-release a retiring channel
    while its producer may be parked in the rendezvous, snapshot it, adopt
    the counters onto a fresh channel, preload the undelivered steps, and
    let the new consumer drain -- every undelivered step must arrive on the
    new edge exactly once, whatever the producer/surgeon interleaving."""
    _mk_file = _payloads(device)
    old = _mk_channel(io_freq=1, queue_depth=1)
    new = _mk_channel(io_freq=1, queue_depth=4)
    got: List[int] = []

    def producer():
        for step in (0, 1):
            old.offer(_mk_file(step))  # step 1 may park in the rendezvous
                                       # until the surgeon's grace release

    def surgeon():
        old.rescale_release_producer()
        snap = old.rescale_snapshot()
        new.rescale_adopt(
            serve_seq=snap["serve_seq"], acked_seq=snap["acked_seq"],
            close_count=snap["close_count"],
            acked_close_count=snap["acked_close_count"],
            done=snap["done"], epoch=2,
            delivered_floor=snap["delivered_seq"])
        for kind, payload, seq, _epoch, _src in snap["items"]:
            assert kind == "memory", kind
            new.rescale_preload(payload, seq)
        new.finish()

    def consumer():
        while True:
            f = new.get()
            if f is None:
                break
            got.append(_payload_value(f))
        # the surgeon snapshots whatever the producer managed to queue
        # before the grace release landed: a prefix of the steps, in order
        assert got == list(range(len(got))), \
            f"surgery lost or duplicated queued steps: {got}"

    return [("producer", producer), ("surgeon", surgeon),
            ("consumer", consumer)]


def traced_rendezvous(device: torch.device) -> _Threads:
    """The depth-1 rendezvous with a ``SpanRecorder`` attached:
    tracing hooks run inside ``offer``/``get`` while the channel lock is
    held, so exploration must show the obs shard locks introduce no new
    races or lock-order edges (they are ``leaf`` rank, innermost), and
    every delivered step must leave exactly one offer + one get span."""
    _mk_file = _payloads(device)
    from ...obs.recorder import SpanRecorder, TraceConfig
    ch = _mk_channel(io_freq=1, queue_depth=1)
    rec = SpanRecorder(TraceConfig(shards=2, flight_len=32))
    ch.set_tracer(rec)
    got: List[int] = []

    def producer():
        for step in range(3):
            assert ch.offer(_mk_file(step)), f"serve of step {step} refused"
        ch.finish()

    def consumer():
        while True:
            f = ch.get()
            if f is None:
                break
            got.append(_payload_value(f))
        assert got == [0, 1, 2], f"lost/duplicated/reordered delivery: {got}"
        spans = rec.spans()
        offers = [s for s in spans if s["name"] == "channel.offer"
                  and not (s["args"] or {}).get("aborted")]
        gets = [s for s in spans if s["name"] == "channel.get"
                and not (s["args"] or {}).get("aborted")]
        assert len(offers) == 3 and len(gets) == 3, \
            f"span count mismatch: {len(offers)} offers, {len(gets)} gets"
        assert all(s["flow"][0] == "s" for s in offers) and \
               all(s["flow"][0] == "f" for s in gets) and \
               {s["flow"][1] for s in offers} == {g["flow"][1] for g in gets}, \
            "offer/get flow ids do not pair up"

    return [("producer", producer), ("consumer", consumer)]


def sem_resize(device: torch.device) -> _Threads:
    """``ResizableSemaphore.resize`` shrink racing a concurrent
    ``release`` (the semaphore audit): the in-use gauge must return to zero,
    no release may error, and nobody may deadlock on any interleaving."""
    from ...core.scheduler import ResizableSemaphore
    sem = ResizableSemaphore(2, name="channel.sem:scenario")

    def worker():
        assert sem.acquire(), "acquire with free permits returned False"
        lockcheck.sched_point("sem_resize.hold", key=("sem-user", id(sem)))
        sem.release()

    def resizer():
        sem.resize(1)
        lockcheck.sched_point("sem_resize.shrunk", key=("sem-user", id(sem)))
        sem.resize(2)

    def check():
        # runs last under the default schedule; under preempted schedules
        # the final decide() still only lets it finish when runnable, and
        # acquire() blocks until both workers are out
        assert sem.acquire(), "acquire after drain returned False"
        sem.release()

    return [("worker-a", worker), ("worker-b", worker),
            ("resizer", resizer), ("checker", check)]


def cow_share(device: torch.device) -> _Threads:
    """CoW hand-off (the protocol, unbroken): a reader holding a view and
    a writer mutating the source must never touch one buffer unordered --
    the writer's first write materializes a private copy, so the shadow-
    state checker over the real ``Dataset`` buffers must stay silent."""
    from ...core.datamodel import File
    base = File("out.h5")
    ds = base.create_dataset("/data", data=np.zeros(4, dtype=np.int64))
    view = ds.view()

    def writer():
        ds[0] = 7          # CoW: copies before the tracked write lands
        assert int(ds.read_direct()[0]) == 7

    def reader():
        arr = view.read_direct()
        total = int(arr.sum())
        assert total == 0, f"reader saw a torn value: {total}"
        assert int(view.read_direct()[0]) == 0, \
            "view observed the writer's private copy"

    return [("writer", writer), ("reader", reader)]


CORPUS: Dict[str, Callable[[torch.device], _Threads]] = {
    "rendezvous_depth1": rendezvous_depth1,
    "latest_fanin": latest_fanin,
    "crash_replay": crash_replay,
    "traced_rendezvous": traced_rendezvous,
    "rescale_window": rescale_window,
    "sem_resize": sem_resize,
    "cow_share": cow_share,
}


def names() -> List[str]:
    return list(CORPUS)


def build_scenario(name: str,
                   device: Union[str, torch.device] = "cuda:0"
                   ) -> Callable[[], _Threads]:
    """The zero-argument builder of scenario ``name`` with its payloads on
    ``device`` (the card unless the caller asks for another); raises when
    that is the card and CUDA is unavailable."""
    try:
        builder = CORPUS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(CORPUS)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the scenarios' payloads "
                           "go to the card; pass device='cpu' to explore "
                           "with payloads on the CPU")
    return functools.partial(builder, device)
