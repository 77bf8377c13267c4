"""Benchmark of ``multigridanisotropicdiffusion_tpu_torch`` on one CUDA card.

    python bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root lists the cells.  A cell names a
configuration (``bench_port/configs/<config>.json``: the port's settings,
taken from the upstream filter's constructor) and a traffic mix
(``bench_port/workloads/<traffic>.json``: the entry, the volume size, how
inputs are drawn, the warm-up, the traced calls and the limits of the
output check).  Each per-layer metric is read by
``bench_port/metrics/<metric>.py``.  A new cell, configuration or metric is
new files and new entries in ``BENCHMARK.json``; nothing here branches on a
cell's name.

The benchmark drives the port only through ``ved`` / ``VEDConfig`` and
``mad_diffusion`` / ``MADConfig``.  It never imports JAX or the JAX package;
``bench_port/reference/`` is a plain PyTorch reference that imports nothing
of the port.
"""
