"""Give child processes the repository's packages.

Several tests launch the command-line entry points in a child process
(`python -m videoitg_tpu.cli.*`) from a temporary directory with a copy of
`os.environ`. Putting the repository root at the front of PYTHONPATH here,
before any test runs, lets those children import the packages without an
installed copy.
"""

import os

_ROOT = os.path.dirname(os.path.abspath(__file__))
_rest = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p and p != _ROOT]
os.environ["PYTHONPATH"] = os.pathsep.join([_ROOT, *_rest])
