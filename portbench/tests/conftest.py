"""The benchmark's CPU tests: run from the root of the checkout,
`python -m pytest portbench/tests -q -p no:cacheprovider`.  They need no
card: the port's kernels are replaced by its plain versions on CPU
tensors, and the harness is driven through `run.measure` past its look
for a card."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.chdir(ROOT)


@pytest.fixture
def card():
    """A CUDA card; the test is skipped where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the card's kernels exist "
                    "only there")
    return "cuda:0"
