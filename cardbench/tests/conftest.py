"""The benchmark's own tests: `python -m pytest -q cardbench/tests` from the
repository's root.  Tests that need the card are marked `cuda` and decide
inside the test whether one is present."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture(autouse=True)
def one_thread():
    """Each test here on one CPU thread: the tiny runs' windows are a few
    seconds, and test processes side by side, each on every core, would
    leave a window too few steps to finish a request."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
