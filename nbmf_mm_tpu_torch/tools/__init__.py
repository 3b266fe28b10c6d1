"""The port's kernel-measurement path: the counterparts of the repository's
``tools/`` probe and benchmark scripts, file for file, each runnable as
``python -m nbmf_mm_tpu_torch.tools.<name>`` on a CUDA card.

``bench_true`` is the harness (slope timing); ``bench_kernels`` times the
library's dense passes; the others time the probes of
:mod:`nbmf_mm_tpu_torch.ops.probes`, which split one sweep pass into its
matmul, elementwise and memory-stream costs.
"""
