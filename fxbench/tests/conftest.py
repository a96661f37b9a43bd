"""Fixtures of the benchmark's tests: its cells cut to a size the CPU runs
in a second or two (the CPU route of the program, the plain versions of
its kernels), and the card's check, made inside a fixture."""

import pytest
import torch

from fxbench.cells import find_cell, load_benchmark

#: The CPU's cut of every configuration: blocks of 4096 samples, 256 bins.
TINY = {"num_samp": 4096, "nbins": 256, "calibrate_samples": 4096,
        "loglevel": "WARNING"}


def tiny_cell(name: str, root=None):
    """Cell ``name`` at the CPU's size; the live cell's receivers deliver
    25 blocks a second."""
    kw = {} if root is None else {"root": root}
    cell = find_cell(load_benchmark(None if root is None
                                    else root / "BENCHMARK.json"), name, **kw)
    cell.config["correlator"].update(TINY)
    if cell.mix["driver"] == "live":
        cell.mix["blocks_per_s"] = 25.0
    if "recording_blocks" in cell.mix:
        cell.mix["recording_blocks"] = 6
    if "blocks" in cell.mix:
        cell.mix["blocks"] = 8
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
