"""The benchmark's tests: run them from the repository's root with
``python -m pytest portbench/tests``; the card's with ``-m cuda`` on a
machine with a CUDA device."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
