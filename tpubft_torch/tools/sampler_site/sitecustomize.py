"""Starts tools/stack_sampler in a replica process (one started with
`--replica`) when TPUBFT_STACK_SAMPLES names a directory; put this
directory on PYTHONPATH to use it (see tools/stack_sampler.py)."""
import os
import sys

if os.environ.get("TPUBFT_STACK_SAMPLES") and "--replica" in sys.argv:
    from tpubft_torch.tools import stack_sampler
    stack_sampler.start(os.environ["TPUBFT_STACK_SAMPLES"])
