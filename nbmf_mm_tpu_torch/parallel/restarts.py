"""Restart parallelism: ``n_init`` random restarts batched into one solve
(counterpart of the JAX package's ``parallel/restarts.py``).

The JAX package ``vmap``s its whole solver core over a leading restart axis.
PyTorch has no ``vmap`` over a hand-written kernel, so here the axis is
written out: the port's cores
(:func:`~nbmf_mm_tpu_torch.solver.driver._solve_core` and
``_solve_core_fused``) take inits with a leading lane axis themselves, every
kernel call carries all lanes over data that is staged once, and the loops
freeze converged lanes by selects while the others run on.
"""

from __future__ import annotations

import numpy as np

from ..utils.profiling import span

__all__ = ["vmapped_solve"]


def vmapped_solve(core, data, inits, hypers, keep_all: bool = False):
    """Run ``core`` (a staged solver core) over a batch of inits.

    The name is the JAX package's, so that a reader finds the counterpart;
    there is no ``vmap`` here: ``core`` is called once, as
    ``core(*data, *inits, *hypers)``, with ``inits = (W0, H0)`` carrying a
    leading ``n_init`` axis, and batches the lanes itself; ``data`` tensors
    and ``hypers`` are shared by all lanes.  Returns ``(best_result,
    best_index, all_final_losses, all_results)`` where ``best_result`` has
    the single-init output structure for the restart with the lowest final
    objective (the first of equals; a NaN counts as lowest, as
    ``jnp.argmin`` has it), and ``all_results`` is the full batched tuple
    when ``keep_all`` (for protocols that evaluate every restart, e.g. the
    paper's 10-init mean +- std tables) and ``None`` otherwise.
    """
    results = core(*data, *inits, *hypers)
    with span("nbmf_mm.select"):
        final_losses = results[4]
        with span("nbmf_mm.wait.argmin"):
            best = int(np.argmin(final_losses.cpu().numpy()))
        best_result = tuple(x[best] for x in results)
    return best_result, best, final_losses, results if keep_all else None
