"""flowbench: the benchmark of ``tpuflow3d_torch`` (``run.py``)."""
