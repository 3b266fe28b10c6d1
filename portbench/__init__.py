"""The benchmark of ``nbmf_mm_tpu_torch`` on one NVIDIA H100.

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python -m portbench.run --workload flagship_fit --seed 7 --seconds 30 --trace 0

``portbench/README.md`` says how the harness finds configurations, traffic
mixes, limits and per-layer metrics by name.  Nothing here imports JAX or
the JAX package; the plain reference (:mod:`portbench.reference`) imports
nothing of the program either.
"""
