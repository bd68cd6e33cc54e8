"""train.backward_idle_share (%): the share of the ``train.backward`` spans'
device intervals inside the profiled sub-window in which the profiler's
trace shows no device operation, the intervals joined to the trace by the
monotonic clock (``lib/program_spans.py``)."""

from insitu_bench.lib import program_spans


def read(raw):
    return program_spans.phase_idle_share(raw, "train.backward")
