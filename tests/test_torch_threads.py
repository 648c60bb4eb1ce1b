"""Torch's intra-op threads in the workers of ``pytest -n W``.

Left at torch's default, each of the W workers runs torch with a thread
for every core, W times the cores in all, and the threads waiting at the
end of a parallel region spin while the cores run other workers' threads:
on an 8-core host with 6 workers (``-n 6 --dist loadfile``) the whole
suite took 1314 s that way, and 583 s with each worker at its share of
the cores (``repro_torch.device.share_host_threads``), the same tests
passing and failing. A worker imports every test module while it collects,
before it runs a test, so the share set here at import holds for the
worker's whole run. A run without xdist keeps torch's default.
"""
import os

import torch

from repro_torch.device import share_host_threads

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    share_host_threads(WORKERS)


def test_an_xdist_worker_runs_torch_on_its_share_of_the_cores():
    if WORKERS > 1:
        assert torch.get_num_threads() == max(
            1, (os.cpu_count() or 1) // WORKERS)


def test_share_host_threads_divides_the_cores_at_least_one_each():
    cores = os.cpu_count() or 1
    before = torch.get_num_threads()
    try:
        assert share_host_threads(1) == cores
        assert torch.get_num_threads() == cores
        assert share_host_threads(2 * cores) == 1
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(before)
