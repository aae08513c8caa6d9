"""pytest settings of the benchmark's own tests (``python -m pytest kbench/tests``).

``card`` marks a test that needs an NVIDIA card; the ``card`` fixture skips
it, deciding when the test runs, never when a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (CUDA); skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    """A factory of a cell of ``BENCHMARK.json`` cut to a size the CPU holds:
    ``tiny_cell(name, nodes, pending, init, **traffic_overrides)``: one node
    group of ``nodes``, ``pending`` pending pods, ``init`` bound at the start."""
    from kbench import manifest

    def make(name, nodes=24, pending=96, init=8, **traffic):
        cell = manifest.load_cell(name)
        groups = [dict(cell.config["node_groups"][0], count=nodes)]
        cell.config = dict(cell.config, node_groups=groups, pending_pods=pending, init_pods=init)
        cell.traffic = dict(cell.traffic, **traffic)
        return cell

    return make
