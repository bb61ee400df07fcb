"""rebuilds.<tag>: the program's ``eager``, ``capture`` and ``kernel_load``
spans that start inside the window (``spans.py``): a body run eagerly, a
graph captured or a kernel library loaded after the warm-up."""

from portbench import spans


def read(run):
    v = spans.view(run)
    return None if v is None else float(v.rebuilds)
