"""The benchmark's yardstick on the CPU: the roofline counts at the shapes
the port's kernel table uses, and each metric reader's arithmetic on
synthetic traces and timings."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from insitu_bench import roofline  # noqa: E402
from insitu_bench.lib import spec  # noqa: E402
from insitu_bench.lib.devtrace import Trace, merge  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def read(metric, raw):
    return spec.reader(metric).read(raw)


def test_k4_count_and_bound_at_mambas_serving_shape():
    """PERF.md's kernel table: K4 at S = 2048, 80 heads of 64, N = 128,
    chunk 256 is 5.45 GFLOP with a 0.0330 ms bound (operations, 3xTF32)."""
    flops, moved = roofline.ssd_work(1, 8, 256, 80, 64, 1, 128)
    assert flops == pytest.approx(5.4466e9, rel=1e-4)
    assert roofline.ssd_bound_s(flops, moved, roofline.peaks(H100)) * 1e3 == \
        pytest.approx(0.0330, abs=5e-5)


def test_mamba2_step_flops_near_six_n_d():
    """The published model's step: about 6 x 2.7e9 parameters x 4096 tokens
    in its projections, plus the scan."""
    w = {"d_model": 2560, "n_layer": 64, "d_state": 128, "headdim": 64,
         "expand": 2, "ngroups": 1, "d_conv": 4, "chunk_size": 256}
    flops = roofline.mamba2_step_flops(w, 2, 2048, 50288)
    assert 6.6e13 < flops < 7.4e13


def test_peaks_know_only_the_cards_in_the_table():
    assert roofline.peaks(H100)["bf16_flops"] == 989e12
    assert roofline.peaks("cpu") is None


def _trace():
    # window [0, 10]; ops overlap in [1, 3], a gap [3, 6], one op past the end
    return Trace(0.0, 10.0, [("gemm", 1.0, 2.0),
                             ("elementwise", 1.5, 3.0),
                             ("adamw", 6.0, 6.5),
                             ("ssd_tc_kernel<2>", 7.0, 11.0)])


def test_trace_union_idle_and_gaps():
    tr = _trace()
    assert tr.busy() == [(1.0, 3.0), (6.0, 6.5), (7.0, 10.0)]
    assert tr.busy_s == pytest.approx(5.5)
    assert tr.idle() == [(0.0, 1.0), (3.0, 6.0), (6.5, 7.0)]
    gaps = tr.idle_gaps([("trainer.step", 2.5, 5.0), ("evaluator.wait", 4.0, 8.0)])
    assert gaps[0] == ["evaluator.wait+trainer.step", pytest.approx(3.0)]
    assert gaps[-1] == ["evaluator.wait", pytest.approx(0.5)]
    assert merge([(0, 1), (0.5, 2), (3, 3)]) == [(0, 2)]


def test_recorded_trace_opens_at_its_first_operation():
    ops = [("before", -2.0, -1.0), ("late", 2.0, 3.0), ("gemm", 4.0, 12.0)]
    tr = Trace.recorded(1.0, 10.0, ops)
    assert (tr.t0, tr.t1) == (2.0, 10.0)          # the card ran unrecorded work
    assert [n for n, _, _ in tr.ops] == ["late", "gemm"]
    assert tr.idle() == [(3.0, 4.0)]
    tr = Trace.recorded(1.0, 10.0, [("first", 0.5, 2.0)])
    assert (tr.t0, tr.busy_s) == (1.0, 1.0)       # never before the profiler's start
    assert Trace.recorded(1.0, 10.0, []).window_s == 9.0


def test_idle_share_readers():
    assert read("device.idle_share.train", {"trace": _trace()}) is None  # no steps
    raw = {"trace": _trace(), "steps": 3}
    assert read("device.idle_share.train", raw) == pytest.approx(45.0)
    assert read("device.idle_share.train", {"trace": None, "steps": 3}) is None


def test_ssd_roofline_and_mfu_readers():
    pk = roofline.peaks(H100)
    flops = pk["bf16_flops"] / 6          # one second at the 3xTF32 rate
    raw = {"trace": _trace(), "device_name": H100,
           "kernel_work": {"ssd_tc_kernel": (flops, 1.0)}}
    assert read("ssd_roofline", raw) == pytest.approx(100 * 1.0 / 4.0)
    raw = {"device_name": H100, "steps": 4, "t0": 0.0, "step_ends": [2.0, 4.0, 6.0, 8.0],
           "model_flops_per_step": pk["bf16_flops"] * 0.1}
    assert read("train.mfu", raw) == pytest.approx(5.0)
    # traced: only the steps that ended before the profiled sub-window
    raw.update(trace=Trace(5.0, 8.0, []), step_ends=[2.0, 4.0, 7.0, 9.0])
    assert read("train.mfu", raw) == pytest.approx(5.0)


def test_end_to_end_readers():
    assert read("setup_s", {"setup_s": 7.5}) == 7.5
    raw = {"window_s": 10.0, "steps": 6, "tokens_per_step": 4096}
    assert read("train_tokens_per_s", raw) == pytest.approx(2457.6)
    assert read("train_tokens_per_s", {**raw, "steps": 0}) is None


def test_counter_and_snapshot_readers():
    assert read("insitu.snapshot_ms", {"snapshot_ms": [10.0, 30.0]}) == 20.0
    assert read("insitu.snapshot_ms", {"snapshot_ms": []}) is None
