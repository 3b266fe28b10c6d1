"""The port's kernel-measurement path: the counterparts of the repository's
``tools/`` probe and benchmark scripts, file for file, each runnable as
``python -m nbmf_mm_tpu_torch.tools.<name>`` on a CUDA card.

``bench_true`` is the harness (slope timing); ``bench_kernels`` times the
library's dense passes; the others time the probes of
:mod:`nbmf_mm_tpu_torch.ops.probes`, which split one sweep pass into its
matmul, elementwise and memory-stream costs.  ``sass_diff`` compares the
kernels' compiled code with that of another copy of the sources, and
``wpass_tune`` and ``hpass_tune`` time variants of the W and H passes to
split their time by phase; ``ab_time`` times the production kernels and the
fused loops of one tree, for comparing two trees on one card.
``stress_solve`` is the randomized stress sweep of ``solve``, the estimator
and the kernels' geometry planners (the counterpart of ``tools/stress_solve.py``).
"""
