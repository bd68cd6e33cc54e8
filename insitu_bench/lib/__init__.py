"""The harness's own parts: finding a cell's files by name (``spec``), the
inputs made from the seed (``inputs``), the device trace (``devtrace``) and
the benchmark's own host spans (``host``).  Nothing here imports the program under test."""
