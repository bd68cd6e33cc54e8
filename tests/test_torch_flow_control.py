"""Flow control on the port (mirrors ``tests/test_flow_control.py``, paper
§3.6, Table 2 behaviour), with tensor payloads, plus the same ``io_freq``
workflows through both packages: equal deliveries, served and dropped
counts."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import Wilkins, h5  # noqa: E402
from repro_torch.core.channel import (Channel, ChannelTimeout,  # noqa: E402
                                      FlowControl)

CPU = torch.device("cpu")


def test_io_freq_decoding():
    assert FlowControl.from_io_freq(0) == (FlowControl.ALL, 1)
    assert FlowControl.from_io_freq(1) == (FlowControl.ALL, 1)
    assert FlowControl.from_io_freq(5) == (FlowControl.SOME, 5)
    assert FlowControl.from_io_freq(-1) == (FlowControl.LATEST, 1)
    with pytest.raises(ValueError):
        FlowControl.from_io_freq(-3)


def _yaml(io_freq):
    return f"""
tasks:
  - func: producer
    outports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    inports:
      - filename: o.h5
        io_freq: {io_freq}
        dsets: [{{name: /g, memory: 1}}]
"""


def _run_workflow(io_freq, n_steps=6, consumer_sleep=0.05, core=tcore):
    got = []
    port = core is tcore

    def producer():
        for t in range(n_steps):
            with core.h5.File("o.h5", "w") as f:
                if port:
                    f.create_dataset("/g", data=torch.tensor([t]), copy=False)
                else:
                    f.create_dataset("/g", data=np.array([t]))

    def consumer():
        while True:
            f = core.h5.File("o.h5", "r")
            if f is None:
                break
            time.sleep(consumer_sleep)
            got.append(int(f["/g"][0]))

    kw = {"devices": [CPU]} if port else {}
    w = core.Wilkins(_yaml(io_freq), {"producer": producer,
                                      "consumer": consumer}, **kw)
    rep = w.run(timeout=60)
    return got, rep


def test_flow_control_all():
    got, rep = _run_workflow(io_freq=1)
    assert got == [0, 1, 2, 3, 4, 5]
    assert rep.total_dropped == 0


def test_flow_control_some():
    got, rep = _run_workflow(io_freq=2)
    assert got == [1, 3, 5]
    assert rep.total_dropped == 3


def test_flow_control_some_n5():
    got, rep = _run_workflow(io_freq=5, n_steps=10)
    assert got == [4, 9]
    assert rep.total_dropped == 8


@pytest.mark.parametrize("io_freq, n_steps, want", [
    (1, 6, [0, 1, 2, 3, 4, 5]), (2, 6, [1, 3, 5]), (3, 7, [2, 5]),
    (5, 10, [4, 9]),
])
def test_served_and_dropped_counts_match_jax(io_freq, n_steps, want):
    """The same ``io_freq`` workflow through both packages: the same steps
    delivered, the same served, dropped and moved counts."""
    tgot, trep = _run_workflow(io_freq, n_steps, 0.0, core=tcore)
    jgot, jrep = _run_workflow(io_freq, n_steps, 0.0, core=jcore)
    assert tgot == jgot == want
    assert (trep.total_served, trep.total_dropped) == \
        (jrep.total_served, jrep.total_dropped) == \
        (len(want), n_steps - len(want))
    assert [(c.stats.served, c.stats.dropped) for c in trep.channels] == \
        [(c.stats.served, c.stats.dropped) for c in jrep.channels]


def test_flow_control_latest_drops_when_consumer_busy():
    got, rep = _run_workflow(io_freq=-1, n_steps=8, consumer_sleep=0.15)
    assert rep.total_dropped > 0
    assert got == sorted(got)
    assert len(got) + rep.total_dropped == 8


def test_flow_control_reduces_producer_wait():
    """The paper's Table 2 effect: 'some' saves producer idle time."""
    _, rep_all = _run_workflow(io_freq=1, n_steps=6, consumer_sleep=0.08)
    _, rep_some = _run_workflow(io_freq=3, n_steps=6, consumer_sleep=0.08)
    wait_all = sum(c.stats.producer_wait_s for c in rep_all.channels)
    wait_some = sum(c.stats.producer_wait_s for c in rep_some.channels)
    assert wait_some < wait_all


def test_gantt_events_recorded():
    yaml = """
tasks:
  - func: p
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: c
    inports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
"""

    def p():
        for t in range(2):
            with h5.File("o.h5", "w") as f:
                f.create_dataset("/g", data=torch.tensor([t]), copy=False)

    def c():
        while True:
            f = h5.File("o.h5", "r")
            if f is None:
                break

    w = Wilkins(yaml, {"p": p, "c": c}, record_events=True, devices=[CPU])
    rep = w.run(timeout=30)
    kinds = {e[3] for e in rep.gantt_events()}
    assert "serve" in kinds and "recv" in kinds


def test_waiter_accounting_dedupes_mux_and_get():
    """A consumer the VOL mux marked waiting that then blocks in ``get`` on
    the same channel is ONE waiter, not two registrations."""
    ch = Channel("w", ("p", 0), ("c", 0), "o.h5", ["/g"], io_freq=-1)
    observed = []
    registered = threading.Event()

    def consumer():
        ch.set_consumer_waiting(True)
        registered.set()
        try:
            with pytest.raises(ChannelTimeout):
                ch.get(timeout=0.5)
        finally:
            ch.set_consumer_waiting(False)

    th = threading.Thread(target=consumer)
    th.start()
    assert registered.wait(2.0)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and th.is_alive():
        observed.append(ch.waiting_consumers())
        time.sleep(0.02)
    th.join(timeout=10)
    assert not th.is_alive()
    assert max(observed) == 1
    assert ch.waiting_consumers() == 0


def test_latest_fanin_rendezvous():
    """2 producers -> 1 `latest` consumer through the VOL mux: data arrives
    fresh and in per-producer order, and waiter accounting drains to zero."""
    yaml = """
tasks:
  - func: producer
    taskCount: 2
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    inports:
      - filename: o.h5
        io_freq: -1
        dsets: [{name: /g, memory: 1}]
"""
    got = []

    def producer(comm):
        for t in range(5):
            with h5.File("o.h5", "w") as f:
                f.create_dataset("/g", copy=False,
                                 data=torch.tensor([comm.instance * 100 + t]))
            time.sleep(0.02)

    def consumer():
        while True:
            f = h5.File("o.h5", "r")
            if f is None:
                break
            got.append(int(f["/g"][0]))

    w = Wilkins(yaml, {"producer": producer, "consumer": consumer},
                devices=[CPU])
    rep = w.run(timeout=60)
    assert rep.total_served + rep.total_dropped == 10
    assert rep.total_served == len(got)
    for inst in (0, 1):
        mine = [g for g in got if g // 100 == inst]
        assert mine == sorted(mine)
    assert all(c.waiting_consumers() == 0 for c in rep.channels)
