"""Metric readers: ``<first part of a metric's name>.py`` reads every
metric whose name starts so, from a run (``harness.Run``), and returns
its value, or None where it finds nothing to read."""
