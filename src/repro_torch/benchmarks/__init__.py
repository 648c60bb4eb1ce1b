"""The paper-figure benchmarks on the port (``benchmarks/`` for ``repro``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig7
"""
