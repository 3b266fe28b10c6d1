"""Batched hyperparameter grid solves (counterpart of the JAX package's
``parallel/grid.py``).

The reference's Figure-1 experiment loops over an (alpha, beta) grid of
independent fits, paying full solver time and a staging of the data per
cell.  Here every grid cell is a lane of one batched solve: the data is
staged once, all cells start from the same seeded initialization, each
kernel call carries all cells, and ``alpha``/``beta`` enter the loop as one
value per lane (the kernels take neither, only ``eps``).  It is the restart
mechanism of :func:`~nbmf_mm_tpu_torch.solver.driver.solve` with the lane
axis on the hyperparameters, where the JAX package ``vmap``s its solver core
over them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_sweep as cs
from ..ops.updates import precompute_masked_terms
from ..solver import driver

__all__ = ["grid_solve"]


@driver.ieee_fp32_products()
def grid_solve(
    Y,
    n_components: int,
    alphas: Sequence[float],
    betas: Sequence[float],
    *,
    max_iter: int = 500,
    tol: float = 1e-5,
    mask=None,
    random_state: Optional[int] = 0,
    eps: float = 1e-8,
    projection: str = "normalize",
    mask_mode: str = "parity",
    dtype=None,
    precision=None,
    pair_mode: str = "product",
    backend: str = "auto",
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    pallas_interpret: bool = False,
    packed: Optional[bool] = None,
    device="cuda",
):
    """Solve NBMF-MM for every (alpha, beta) cell in one batched solve.

    ``pair_mode="product"`` runs the full cartesian grid
    ``len(alphas) x len(betas)`` (``alphas`` outermost); ``"zip"`` pairs them
    elementwise.  All cells share the seeded initialization that
    ``solve(random_state=...)`` draws for one fit (as the reference's grid
    loop does with a fixed ``random_state``), which isolates the
    hyperparameter effect and makes a cell the standalone fit with that
    seed.  The orientation is beta-dir.

    ``scipy.sparse`` input densifies here (hyperparameter grids run at paper
    scale; the sparse ingestion without dense staging is ``solve``'s, which
    a per-cell loop can use at sizes only the packed words fit).

    ``dtype``, ``precision``, ``backend``, ``packed`` and ``device`` follow
    ``solve``: float32 (default), float64 or ``"bfloat16"`` (the data stored
    bf16 on the fused loop, every cell a lane over that one copy, never
    packed; ``packed=True`` with it raises); the product tier ``None``/
    ``"highest"``, ``"high"`` or ``"default"``, which every kernel call of
    every cell runs; ``"auto"``, ``"fused"`` or ``"plain"``; ``packed=None``
    streams exactly-binary data (and mask) as packed words on the fused
    loop, ``False`` streams dense, ``True`` requires the words and raises
    otherwise; ``device`` defaults to ``"cuda"`` and raises without a card.
    As in ``solve``, the JAX package's ``"pallas"``/``"jnp"`` name the fused
    and plain loops, ``block_m``/``block_n`` are accepted and ignored (the
    port plans its own tiling), and ``pallas_interpret=True`` is what CPU
    tensors do anyway and raises ``ValueError`` on a CUDA device.

    Returns a dict of numpy arrays with a leading grid axis ``G``:
    ``alpha (G,)``, ``beta (G,)``, ``W (G, m, k)``, ``H (G, k, n)``,
    ``losses (G, max_iter)`` (zero past a cell's ``n_iter``), ``n_iter (G,)``,
    ``final_loss (G,)`` and ``converged (G,)``.
    """
    if projection not in ("normalize", "duchi"):
        raise ValueError(f"projection must be 'normalize' or 'duchi', got {projection!r}")
    if mask_mode not in ("parity", "corrected"):
        raise ValueError(f"unknown mask_mode: {mask_mode!r}")
    if max_iter < 1:
        raise ValueError(f"grid_solve needs max_iter >= 1, got {max_iter}")
    dtype, data_dtype = driver._resolve_dtype(dtype)
    tier = driver._resolve_precision(precision, data_dtype)
    device = cs.resolve_device(device)
    driver._check_interpret(pallas_interpret, device)
    k = int(n_components)

    if pair_mode == "product":
        A, B = np.meshgrid(np.asarray(alphas, dtype=float), np.asarray(betas, dtype=float),
                           indexing="ij")
        a_flat, b_flat = A.ravel(), B.ravel()
    elif pair_mode == "zip":
        a_flat = np.asarray(alphas, dtype=float)
        b_flat = np.asarray(betas, dtype=float)
        if a_flat.shape != b_flat.shape:
            raise ValueError("zip pair_mode requires len(alphas) == len(betas)")
    else:
        raise ValueError(f"unknown pair_mode: {pair_mode!r}")
    cells = a_flat.size
    if not 1 <= cells <= cs.MAX_LANES or a_flat.ndim != 1:
        raise ValueError(f"a grid takes 1 to {cs.MAX_LANES} cells as 1-D alphas and betas, "
                         f"got {a_flat.shape}")
    route = driver._resolve_backend(backend, dtype, device, True, packed, k)
    if packed is True and data_dtype is not None:
        raise ValueError("packed=True is incompatible with dtype='bfloat16': packing replaces "
                         "the data stream (and is both smaller and exact)")
    data_dtype = data_dtype if route == "fused" else None  # as solve stages it

    Y = driver._to_tensor(Y, data_dtype or dtype, device)
    mask = None if mask is None else driver._to_tensor(mask, data_dtype or dtype, device)
    m, n = Y.shape
    n_obs = float(m * n) if mask is None else float(torch.count_nonzero(mask))
    if n_obs == 0.0:
        raise ValueError("mask has no observed entries (all zeros): the per-entry "
                         "objective is undefined with n_obs == 0")

    # The init of solve(random_state=...) with n_init=1, read from the solver
    # module at call time, so that a cell is the standalone fit with that seed.
    seed = 0 if random_state is None else int(random_state)
    W0_ext, H0 = driver._random_uniform_inits(seed, 1, m, n, k, dtype)
    W0 = driver._internal_simplex_factor(W0_ext[0], device)  # (k, m)
    H0 = H0[0].to(device)

    def lanes(A):  # every cell starts from the same factors
        return A.expand(cells, *A.shape).contiguous()

    loop = dict(max_iter=max_iter, projection=projection, verbose=0)
    if route == "fused":
        bm, Mp, Np = cs.plan_packing(m, n)
        Y1, Y2, use_packed = driver._stage_dense(Y, mask, Mp=Mp, Np=Np, bm=bm, packed=packed)
        if packed is True and not use_packed:
            raise ValueError("packed=True requires exactly binary data (and mask)")
        del Y, mask
        W, H, losses, n_iter, final_loss, done = driver._solve_core_fused(
            Y1, Y2 if mask_mode == "corrected" else None, Y2,
            lanes(driver._pad_last(W0, Mp)), lanes(driver._pad_last(H0, Np)),
            a_flat, b_flat, tol, n_obs,
            packed=use_packed, eps=eps, m_real=m, n_real=n, bm=bm, mxu_precision=tier, **loop)
        W, H = W[:, :, :m], H[:, :, :n]
    else:
        Ym, Ym2, Yc = precompute_masked_terms(Y, mask, mask_mode)
        W, H, losses, n_iter, final_loss, done = driver._solve_core(
            Ym, Ym2, Yc, lanes(W0), lanes(H0), a_flat, b_flat, tol, eps, n_obs, n,
            precision=tier, **loop)
    host = lambda t: t.cpu().numpy()
    return {
        "alpha": a_flat,
        "beta": b_flat,
        "W": np.swapaxes(host(W), 1, 2),  # external (G, m, k)
        "H": host(H),
        "losses": host(losses),
        "n_iter": host(n_iter),
        "final_loss": host(final_loss),
        "converged": host(done),
    }
