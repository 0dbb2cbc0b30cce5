"""Small sizes of the benchmark's cells, for runs on the CPU."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
# (configuration, mix) keys replaced in the CPU runs: the same code at a size a test holds.
TINY = {
    "c3_bulk512": ({"rows": 20000}, {"pool_requests": 4, "queries_per_request": 64, "sample": 64}),
    "c4_asset1": ({"assets": 300, "chunks_per_asset": 20}, {"pool_requests": 8, "sample": 4}),
}


@pytest.fixture(scope="session")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cuda():
    """The CUDA card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
