"""The experiment runners of the port (counterparts of the repository's
``experiments/``), each run as ``python -m
nbmf_mm_tpu_torch.experiments.<name> --device cuda``:

- ``reproduce_magron2022``: the paper's Figures 1-3 on animals, lastfm and
  paleo (the (alpha, beta) grid, the 10-init test protocols of NBMF-MM,
  NBMF-EM and logPCA, the rank sweep);
- ``benchmark_suite``: fit quality and time on the paper's datasets, the
  README quickstart and the sweep throughput at the headline size;
- ``flagship_scale``: packed solves of 10^9 to 10^10 entries whose data is
  made and packed chunk by chunk on the card;
- ``validate_implementation``: descent, simplex and box constraints on
  synthetic data in both orientations (exit code 0 iff every check passes).

They write CSVs with the JAX runners' columns to ``--outdir`` (by default
``chiprun_out/experiments/`` of the repository), never under ``outputs/``,
which holds the JAX round's results.  :mod:`.data` loads the datasets and
their splits.
"""
