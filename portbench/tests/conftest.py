"""The harness's tests import it as ``portbench`` from the checkout's root,
and never the JAX package's test configuration."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
