"""setup_s: seconds from the process's start to the window's start (load,
weights, kernel builds, the warm-up steps)."""


def read(raw):
    return raw["setup_s"]
