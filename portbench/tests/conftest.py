"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``
from the root of a checkout.  They run the cells at tiny sizes on the
CPU (the kernels' plain versions) and need no card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
