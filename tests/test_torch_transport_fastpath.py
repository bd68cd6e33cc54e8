"""The port's zero-copy transport fast path beside the JAX package's: the
twin of ``tests/test_transport_fastpath.py`` (CoW views, shared fan-out
payloads, pipelined channels, the raw mmap spill container and
``ChannelTimeout``).

Data enters as tensors made from numpy arrays.  With the default
``copy=True`` a dataset snapshots a tensor into a host array, exactly as
the reference snapshots a numpy array (one counted copy), so the CoW and
sharing assertions hold on the host buffers in both packages; the
transport counters of each unit case are held equal to the reference's
on the same inputs.  Workflows run through both packages (``torch_twins``).
Each reference case has a twin of the same name.  By design:

* ``test_spill_load_is_mmap_backed_and_aligned`` also loads the
  reference's container with the port and the port's with the
  reference, and asserts that a tensor written through a ``file: 1``
  edge comes back from ``File.load`` as an ``np.memmap``;
* ``test_queue_depth_pipelines_producer``, the ``ChannelTimeout``/mux
  cases, ``test_run_timeout_is_one_global_deadline`` and the matcher,
  event-ring and glob-cache cases check the port's own channel
  machinery and run the port alone.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import channel as jchannel  # noqa: E402
from repro.core import datamodel as jdm  # noqa: E402
from repro.core import vol as jvol  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Wilkins  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import datamodel as tdm  # noqa: E402
from repro_torch.core import vol as tvol  # noqa: E402
from repro_torch.core.channel import (NO_DATA, Channel, ChannelMux,  # noqa: E402
                                      ChannelTimeout)
from repro_torch.core.datamodel import (File, compile_path_pattern,  # noqa: E402
                                        match_path,
                                        reset_transport_stats, transport_stats)
from repro_torch.core.vol import VOL  # noqa: E402
from torch_twins import CPU, assert_same, run_both  # noqa: E402

PKGS = (("port", tdm, tchannel, tvol), ("jax", jdm, jchannel, jvol))


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), CPU)


def _data(name, a):
    return _t(a) if name == "port" else np.asarray(a)


# ---------------------------------------------------------------------------
# CoW dataset views
# ---------------------------------------------------------------------------
def test_view_shares_memory_until_write():
    snaps = {}
    for name, dm, _, _ in PKGS:
        f = dm.File("a.h5")
        ds = f.create_dataset("/g/d", data=_data(name, np.arange(16.0)))
        v = ds.view()
        assert np.shares_memory(v.read_direct(), ds.read_direct())
        assert ds.share_count == 2 and v.share_count == 2
        dm.reset_transport_stats()
        v[0] = 99.0
        s = dm.transport_stats().snapshot()
        assert s["cow_copies"] == 1
        assert s["bytes_copied"] == ds.nbytes
        assert not np.shares_memory(v.read_direct(), ds.read_direct())
        assert v[0] == 99.0 and ds[0] == 0.0
        v[1] = 5.0
        assert dm.transport_stats().snapshot()["cow_copies"] == 1
        snaps[name] = dm.transport_stats().snapshot()
    assert snaps["port"] == snaps["jax"]


def test_create_dataset_snapshots_caller_array():
    scratch = _t(np.arange(8.0))
    f = File("a.h5")
    ds = f.create_dataset("/d", data=scratch)
    assert not np.shares_memory(ds.read_direct(), scratch.numpy())
    scratch[:] = -1.0
    assert ds[0] == 0.0


def test_view_write_through_source_also_copies():
    f = File("a.h5")
    ds = f.create_dataset("/d", data=_t(np.zeros(8)))
    v = ds.view()
    ds[3] = 7.0
    assert ds[3] == 7.0 and v[3] == 0.0


def test_shared_buffer_reads_are_readonly_aliases():
    f = File("a.h5")
    ds = f.create_dataset("/d", data=_t(np.arange(4)))
    v = ds.view()
    alias = v.read_direct()
    assert not alias.flags.writeable
    with pytest.raises(ValueError):
        alias[0] = 1


def test_file_view_is_structural_and_zero_copy():
    for name, dm, _, _ in PKGS:
        f = dm.File("x.h5")
        f.attrs["run"] = 1
        d = f.create_dataset("/a/b", data=_data(name, np.ones((4, 4))))
        d.attrs["t"] = 2
        dm.reset_transport_stats()
        fv = f.view()
        assert dm.transport_stats().snapshot()["bytes_copied"] == 0
        assert np.shares_memory(fv["/a/b"].read_direct(), d.read_direct())
        assert fv.attrs["run"] == 1 and fv["/a/b"].attrs["t"] == 2


# ---------------------------------------------------------------------------
# fan-out shares one payload
# ---------------------------------------------------------------------------
def test_fanout_serves_one_shared_payload():
    snaps = {}
    for name, dm, ch_mod, vol_mod in PKGS:
        vol = vol_mod.VOL("producer")
        chans = [ch_mod.Channel(f"p->c{i}", ("producer", 0), ("consumer", i),
                                "o.h5", ["/grid"]) for i in range(4)]
        vol.outgoing.extend(chans)
        f = dm.File("o.h5")
        src = f.create_dataset("/grid", data=_data(
            name, np.arange(1000, dtype=np.int64)))
        dm.reset_transport_stats()
        vol.on_file_close(f)
        assert dm.transport_stats().snapshot()["bytes_copied"] == 0
        got = [c.get(timeout=5) for c in chans]
        arrs = [g["/grid"].read_direct() for g in got]
        for a in arrs:
            assert np.shares_memory(a, src.read_direct())
        np.testing.assert_array_equal(arrs[0], np.arange(1000, dtype=np.int64))
        snaps[name] = dm.transport_stats().snapshot()
    assert snaps["port"]["copies"] == snaps["jax"]["copies"] == 0
    assert snaps["port"]["views"] == snaps["jax"]["views"]


FANOUT_YAML = """
tasks:
  - func: producer
    outports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
  - func: consumer
    taskCount: 4
    inports:
      - filename: o.h5
        dsets: [{name: /g, memory: 1}]
"""


def _fanout(s):
    received = []

    def producer():
        with s.h5.File("o.h5", "w") as f:
            f.create_dataset("/g", data=s.data(np.arange(256.0)))

    def consumer(comm):
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            with s.lock:
                received.append(f["/g"].read_direct())
            s.record(("consumer", comm.instance, 0, 0), f["/g"])

    rep = s.wilkins(FANOUT_YAML, {"producer": producer,
                                  "consumer": consumer}).run(timeout=60)
    assert len(received) == 4
    for a in received[1:]:
        assert np.shares_memory(received[0], a)
    return rep


def test_fanout_workflow_consumers_share_memory():
    t, j = run_both(_fanout)
    assert len(t.side.got) == 4
    assert_same(t, j)


def test_legacy_mode_materializes_copies():
    snaps = {}
    for name, dm, ch_mod, vol_mod in PKGS:
        vol = vol_mod.VOL("producer")
        chans = [ch_mod.Channel(f"p->c{i}", ("producer", 0), ("consumer", i),
                                "o.h5", ["/g"], zero_copy=False)
                 for i in range(3)]
        vol.outgoing.extend(chans)
        f = dm.File("o.h5")
        src = f.create_dataset("/g", data=_data(name, np.zeros(512)))
        dm.reset_transport_stats()
        vol.on_file_close(f)
        assert dm.transport_stats().snapshot()["bytes_copied"] == 3 * src.nbytes
        for c in chans:
            g = c.get(timeout=5)
            assert not np.shares_memory(g["/g"].read_direct(), src.read_direct())
        snaps[name] = dm.transport_stats().snapshot()["copies"]
    assert snaps["port"] == snaps["jax"] == 3


# ---------------------------------------------------------------------------
# raw mmap spill container
# ---------------------------------------------------------------------------
def _snap_file(dm, name):
    f = dm.File("snap.h5")
    f.attrs["step"] = 12
    d = f.create_dataset("/grid", data=_data(name, np.arange(100, dtype=np.int64)))
    d.attrs["timestep"] = 3
    own = dm.BlockOwnership()
    own.add(0, (0,), (50,))
    own.add(1, (50,), (50,))
    d.ownership = own
    f.create_dataset("/p/pos", data=_data(name, np.ones((10, 3), np.float32)))
    return f


def test_spill_roundtrip_preserves_attrs_and_ownership(tmp_path):
    f = _snap_file(tdm, "port")
    path = f.save(str(tmp_path / "port"))
    g = File.load(path)
    np.testing.assert_array_equal(g["/grid"][:], np.arange(100, dtype=np.int64))
    assert g.attrs["step"] == 12
    assert g["/grid"].attrs["timestep"] == 3
    assert g["/grid"].ownership.blocks[1] == ((50,), (50,))
    assert g.total_bytes() == f.total_bytes()
    jpath = _snap_file(jdm, "jax").save(str(tmp_path / "jax"))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()


def test_spill_load_is_mmap_backed_and_aligned(tmp_path):
    f = File("snap.h5")
    f.create_dataset("/a", data=_t(np.arange(7, dtype=np.int8)))
    f.create_dataset("/b", data=_t(np.arange(5, dtype=np.float64)))
    f.create_dataset("/c", data=_t(np.arange(6, dtype=np.float32)), copy=False)
    path = f.save(str(tmp_path))

    reset_transport_stats()
    g = File.load(path, mmap=True)
    assert transport_stats().snapshot()["bytes_copied"] == 0
    for p in ("/a", "/b", "/c"):       # an adopted tensor spills to host bytes
        a = g[p].read_direct()
        assert isinstance(a, np.memmap) or isinstance(a.base, np.memmap), p
    np.testing.assert_array_equal(g["/b"][:], np.arange(5, dtype=np.float64))
    np.testing.assert_array_equal(g["/c"][:], np.arange(6, dtype=np.float32))
    with open(path, "rb") as fh:
        assert fh.read(8) == b"WLKNRAW1"
        hlen = int.from_bytes(fh.read(8), "little")
        meta = json.loads(fh.read(hlen).decode())
    for info in meta["datasets"].values():
        assert info["offset"] % 64 == 0
    # the reference reads the port's container the same way
    jg = jdm.File.load(path, mmap=True)
    for p in ("/a", "/b", "/c"):
        np.testing.assert_array_equal(np.asarray(jg[p][:]), g[p][:])


def test_spill_roundtrip_empty_and_scalar_datasets(tmp_path):
    f = File("e.h5")
    f.create_dataset("/empty", data=_t(np.zeros((0, 3), np.float32)))
    f.create_dataset("/scalar", data=_t(np.float64(7.5)), shape=())
    f.create_dataset("/d", data=_t(np.arange(4)))
    path = f.save(str(tmp_path))
    for g in (File.load(path), jdm.File.load(path)):
        assert g["/empty"].shape == (0, 3)
        assert float(g["/scalar"][()]) == 7.5
        np.testing.assert_array_equal(g["/d"][:], np.arange(4))


def test_spill_loaded_dataset_is_cow_writable(tmp_path):
    f = File("s.h5")
    f.create_dataset("/d", data=_t(np.arange(10.0)))
    path = f.save(str(tmp_path))
    g = File.load(path)
    g["/d"][0] = -1.0
    assert g["/d"][0] == -1.0
    h = File.load(path)
    assert h["/d"][0] == 0.0


SPILL_YAML = """
tasks:
  - func: p
    outports:
      - filename: out.h5
        dsets: [{name: /d, file: 1, memory: 0}]
  - func: c
    inports:
      - filename: out.h5
        dsets: [{name: /d, file: 1, memory: 0}]
"""


def _spill(s, tmp_path):
    spill = tmp_path / s.name
    spill.mkdir()

    def p():
        for t in range(3):
            with s.h5.File("out.h5", "w") as f:
                f.attrs["step"] = t
                # the port hands the tensor over in place; the spill writes
                # its bytes and the consumer gets them back memory-mapped
                kw = {"copy": False} if s.port else {}
                f.create_dataset("/d", data=s.data(np.arange(10.0) + t), **kw)

    def c():
        while True:
            f = s.h5.File("out.h5", "r")
            if f is None:
                break
            d = f["/d"].read_direct()
            assert isinstance(d, np.memmap) or isinstance(d.base, np.memmap)
            s.record(("c", 0, 0, int(f.attrs["step"])), d)

    rep = s.wilkins(SPILL_YAML, {"p": p, "c": c},
                    spill_dir=str(spill)).run(timeout=30)
    assert os.listdir(str(spill)) == []
    return rep


def test_file_transport_spill_cleans_up(tmp_path):
    t, j = run_both(_spill, tmp_path)
    assert len(t.side.got) == 3
    dt, shape, raw = t.side.got[("c", 0, 0, 2)]
    np.testing.assert_array_equal(np.frombuffer(raw, dt), np.arange(10.0) + 2)
    # the port adopted its tensors (no snapshot copy); nothing else differs
    assert_same(t, j, counters=("redist_shipped_bytes", "reshard_numpy"))


# ---------------------------------------------------------------------------
# queue_depth pipelining
# ---------------------------------------------------------------------------
def _pipeline_yaml(queue_depth):
    return f"""
tasks:
  - func: producer
    outports:
      - filename: o.h5
        dsets: [{{name: /g, memory: 1}}]
  - func: consumer
    inports:
      - filename: o.h5
        queue_depth: {queue_depth}
        dsets: [{{name: /g, memory: 1}}]
"""


def _queue(s, depth):
    n = 8
    got = []

    def producer():
        for t in range(n):
            with s.h5.File("o.h5", "w") as f:
                f.create_dataset("/g", data=s.data(np.array([t])))

    def consumer():
        while True:
            f = s.h5.File("o.h5", "r")
            if f is None:
                break
            time.sleep(0.01)
            got.append(int(f["/g"][0]))
            s.record(("consumer", 0, 0, got[-1]), f["/g"])

    rep = s.wilkins(_pipeline_yaml(depth), {"producer": producer,
                                            "consumer": consumer}).run(timeout=60)
    assert got == list(range(n))
    assert rep.total_served == n and rep.total_dropped == 0
    return rep


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_queue_depth_serves_all_steps_in_order(depth):
    t, j = run_both(_queue, depth)
    assert_same(t, j)


def test_queue_depth_pipelines_producer():
    ch1 = Channel("d1", ("p", 0), ("c", 0), "o.h5", ["/g"], queue_depth=1)
    ch2 = Channel("d2", ("p", 0), ("c", 0), "o.h5", ["/g"], queue_depth=2)
    f = File("o.h5")
    f.create_dataset("/g", data=_t(np.zeros(4)))
    assert ch1.offer(f) and ch2.offer(f)
    assert ch2.offer(f)
    assert ch2.peek_pending()
    done = []
    t = threading.Thread(target=lambda: done.append(ch1.offer(f)))
    t.start()
    time.sleep(0.05)
    assert not done
    assert ch1.get(timeout=5) is not None
    t.join(timeout=5)
    assert done == [True]
    assert ch2.get(timeout=5) is not None and ch2.get(timeout=5) is not None


def test_graph_queue_depth_from_yaml():
    from repro_torch.core.graph import WorkflowGraph

    g = WorkflowGraph.from_yaml(_pipeline_yaml(3))
    assert g.edges[0].queue_depth == 3
    w = Wilkins(_pipeline_yaml(3), {"producer": lambda: None,
                                    "consumer": lambda: None}, devices=[CPU])
    assert w.channels[0].queue_depth == 3
    with pytest.raises(ValueError):
        WorkflowGraph.from_yaml(_pipeline_yaml(0))


# ---------------------------------------------------------------------------
# ChannelTimeout + mux
# ---------------------------------------------------------------------------
def test_get_timeout_raises_not_none():
    ch = Channel("t", ("p", 0), ("c", 0), "o.h5", ["/g"])
    t0 = time.monotonic()
    with pytest.raises(ChannelTimeout):
        ch.get(timeout=0.05)
    assert time.monotonic() - t0 >= 0.05
    assert ch.stats.consumer_wait_s > 0
    ch.finish()
    assert ch.get(timeout=0.05) is None


def test_try_get_sentinels():
    ch = Channel("t", ("p", 0), ("c", 0), "o.h5", ["/g"])
    assert ch.try_get() is NO_DATA
    f = File("o.h5")
    f.create_dataset("/g", data=_t(np.ones(3)))
    assert ch.offer(f)
    out = ch.try_get()
    assert out is not NO_DATA and out is not None
    ch.finish()
    assert ch.try_get() is None


def test_mux_no_missed_wakeup():
    mux = ChannelMux()
    token = mux.token()
    mux.notify()
    t0 = time.monotonic()
    assert mux.wait(token, timeout=5) != token
    assert time.monotonic() - t0 < 1.0


def test_fanin_mux_delivers_from_any_channel():
    chans = [Channel(f"p{i}", ("p", i), ("c", 0), "o.h5", ["/g"]) for i in range(3)]
    vol = VOL("c")
    vol.incoming.extend(chans)

    def producer(i, delay):
        time.sleep(delay)
        f = File("o.h5")
        f.create_dataset("/g", data=_t(np.array([i])))
        chans[i].offer(f)
        chans[i].finish()

    threads = [threading.Thread(target=producer, args=(i, 0.02 * (i + 1)))
               for i in range(3)]
    for t in threads:
        t.start()
    got = []
    while True:
        f = vol.on_file_open("o.h5")
        if f is None:
            break
        got.append(int(f["/g"][0]))
    for t in threads:
        t.join()
    assert sorted(got) == [0, 1, 2]


# ---------------------------------------------------------------------------
# global run deadline, matches_file memo, bounded event ring
# ---------------------------------------------------------------------------
def test_run_timeout_is_one_global_deadline():
    yaml = """
tasks:
  - func: a
    taskCount: 3
  - func: b
    taskCount: 3
"""
    release = threading.Event()

    def hang():
        release.wait(5.0)

    w = Wilkins(yaml, {"a": hang, "b": hang}, devices=[CPU])
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        w.run(timeout=0.3)
    elapsed = time.monotonic() - t0
    release.set()
    assert elapsed < 1.5


def test_matches_file_is_memoized():
    ch = Channel("m", ("p", 0), ("c", 0), "plt*.h5", ["/g"])
    assert ch.matches_file("plt00010.h5")
    assert not ch.matches_file("other.h5")
    assert ch._match_cache == {"plt00010.h5": True, "other.h5": False}
    assert ch.matches_file("plt00010.h5") and not ch.matches_file("other.h5")


def test_event_ring_is_bounded_with_drop_counter():
    ch = Channel("e", ("p", 0), ("c", 0), "o.h5", ["/g"],
                 record_events=True, events_maxlen=8)
    for i in range(20):
        ch._event_locked("producer", f"tick{i}")
    assert len(ch.stats.events) == 8
    assert ch.stats.events_dropped == 12
    assert ch.stats.events[-1][2] == "tick19"
    assert ch.stats.events[0][2] == "tick12"


# ---------------------------------------------------------------------------
# glob matcher cache
# ---------------------------------------------------------------------------
def test_compiled_pattern_cache_hits():
    m1 = compile_path_pattern("/group1/*")
    m2 = compile_path_pattern("/group1/*")
    assert m1 is m2
    assert m1.matches("/group1/grid")
    assert m1.matches("/group1/deep/nest")
    assert not m1.matches("/other/grid")
    assert match_path("/group1/*", "/group1/grid")
