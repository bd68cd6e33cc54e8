"""train.backward_ms: the median, over the window's steps that ended before
the profiled sub-window, of the device time of the step's ``train.backward``
span: the card's clock between the CUDA events the program records at the
phase's boundaries (``lib/program_spans.py``)."""

from insitu_bench.lib import program_spans


def read(raw):
    return program_spans.phase_device_ms(raw, "train.backward")
