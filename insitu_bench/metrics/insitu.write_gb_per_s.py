"""insitu.write_gb_per_s: the payload the program's snapshot writes take in,
the ``bytes`` of the window's ``vol.file`` spans over their summed host
seconds, in GB/s (``lib/program_spans.py``)."""

from insitu_bench.lib import program_spans


def read(raw):
    return program_spans.write_gb_per_s(raw)
