"""insitu.write_ms: the program's snapshot write, the mean of its
``vol.file`` spans (file creation, dataset writes, close, serve and offer,
on the host's clock) that start inside the window (``lib/program_spans.py``)."""

from insitu_bench.lib import program_spans


def read(raw):
    return program_spans.write_ms(raw)
