"""The benchmark's own tests: the harness, its yardstick and references
at tiny sizes on the CPU, and (marked ``cuda``) the controls on a card.

    python -m pytest benchmark/tests -q             # here, on the CPU
    python -m pytest benchmark/tests -q -m cuda     # on a card
"""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (BENCH_DIR, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)
