"""NBMF-MM solver driver on PyTorch (counterpart of
the JAX package's ``solver/driver.py``).

Two loops solve one initialization, or a batch of them in lockstep, both on
the caller's device:

- :func:`_solve_core` — the plain loop (counterpart of the JAX ``"jnp"``
  route): :func:`~nbmf_mm_tpu_torch.ops.updates.mm_sweep` and
  :func:`~nbmf_mm_tpu_torch.ops.updates.map_objective` on dense operands;
- :func:`_solve_core_fused` — the shifted-loss kernel loop (counterpart of
  ``_solve_core_pallas``): per sweep one H pass (H-update terms and the
  previous sweep's loss) and one W pass (W-update terms), over bit-packed
  words (:mod:`~nbmf_mm_tpu_torch.ops.cuda_sweep`) for exactly-binary
  operands or over dense f32 operands
  (:mod:`~nbmf_mm_tpu_torch.ops.dense_sweep`) for ``[0, 1]``-valued data
  and weighted masks; ``packed`` chooses, as in the JAX package.

Restarts (``n_init > 1``) and hyperparameter grids
(:func:`~nbmf_mm_tpu_torch.parallel.grid.grid_solve`) are one mechanism, as
in the JAX package, where it is ``jax.vmap`` of the solver core: the factors
carry a leading lane axis ``R`` (``W0 (R, k, m)``, ``H0 (R, k, n)``), the data
is staged once and shared, and ``alpha``/``beta`` are floats or one value per
lane.  The lanes go through every kernel launch together, and the loops keep
the JAX freeze semantics: a lane that has converged keeps its factors,
losses and counter by selects while the others run on, so each lane ends
where its own solve would.  Both loops read one stopping flag (all lanes
done) back to the host once per sweep and leave the loop when it is set.
The "dir-beta" orientation runs the beta-dir loop on ``Y.T`` with the factors
swapped, as the reference does.  Random inits come from a CPU
``torch.Generator`` seeded with ``random_state``
(:func:`_random_uniform_inits`) and then move to the device, so a seed gives
the same inits on the CPU and on the card (they differ from JAX ``PRNGKey``
draws).

Input that is packed already (:class:`~nbmf_mm_tpu_torch.ops.packed.PackedMatrix`)
or sparse (``scipy.sparse`` data, alone or under a sparse mask) reaches the
packed loop without a dense copy on the host or the device; every other
routing of sparse input densifies it and gives the dense-input result.

``precision`` chooses a product tier and ``dtype="bfloat16"`` stores the data
bf16 (:mod:`~nbmf_mm_tpu_torch.ops.tiers` defines both); the loops pass the
tier to every kernel and plain product, and the kernel wrappers pick the
bf16-data instances from the operands' dtype.

While a profiler records (:func:`~nbmf_mm_tpu_torch.utils.profiling.trace`),
``solve`` marks its layers with spans (:func:`~nbmf_mm_tpu_torch.utils.profiling.span`):
``nbmf_mm.solve`` around the call; in it ``nbmf_mm.stage`` (``init_draw``,
``init_copy``, ``operands``), ``nbmf_mm.loop`` with one ``nbmf_mm.sweep`` a
sweep, ``nbmf_mm.select`` for restarts and ``nbmf_mm.finish``; and
``nbmf_mm.wait.<site>`` around each blocking host read (``stop_flag``,
``binary_scan``, ``n_obs``, ``result``, ``argmin``, ``drift``).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_sweep as cs
from ..ops import dense_sweep as ds
from ..ops import tiers
from ..ops.packed import (
    PackedMatrix,
    csr_binary_canonical,
    pack_matrix_sparse,
    pack_sparse_words,
)
from ..ops.projection import project_simplex_duchi
from ..ops.updates import (
    clip_upper_interior,
    map_objective,
    mm_sweep,
    precompute_masked_terms,
)
from ..utils import debugging
from ..utils.profiling import span

__all__ = ["nbmf_mm_solver", "solve", "SolverResult"]

_ORIENTATIONS = ("beta-dir", "dir-beta")
_BACKENDS = ("auto", "fused", "plain")
# The JAX package's backend names: its XLA loop is the plain loop, its Pallas
# loop the fused one.
_BACKEND_ALIASES = {"jnp": "plain", "pallas": "fused"}


def canonical_backend(backend: str) -> str:
    """``backend`` with the JAX package's names mapped to the port's."""
    return _BACKEND_ALIASES.get(backend, backend)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def _check_interpret(interpret: bool, device: torch.device,
                     name: str = "pallas_interpret") -> None:
    """The JAX package's interpret flag: on the CPU it is what the kernel
    wrappers do anyway (their plain versions); on a CUDA device the kernels
    run, so asking for the interpreter there raises instead of substituting
    the plain versions silently."""
    if interpret and device.type == "cuda":
        raise ValueError(f"{name}=True runs the kernels' plain versions, which this package "
                         "takes only for CPU tensors; pass device='cpu', or drop it to run "
                         "the CUDA kernels")


def _check_mesh(mesh, mesh_axes, what: str) -> None:
    """``mesh_axes`` is stored and checked only together with ``mesh``,
    which is not ported yet."""
    if mesh is None:
        return
    axes = tuple(mesh_axes)
    if len(axes) != 2 or not all(isinstance(a, str) for a in axes):
        raise ValueError(f"mesh_axes must be two axis names, got {mesh_axes!r}")
    raise _not_ported(what, "Multi-GPU")


@contextlib.contextmanager
def ieee_fp32_products():
    """IEEE fp32 matmul products inside, the caller's settings back outside.

    PyTorch's TF32 switches are process-wide, so a solve or a fold-in turns
    them off only for its own duration and restores what it found on every
    exit, exceptions included.  Also usable as a decorator.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass
class SolverResult:
    """Full solver output (the tuple API of :func:`nbmf_mm_solver` is a view).

    ``W`` is ``(m, k)`` and ``H`` is ``(k, n)`` in *external* notation for the
    requested orientation, as numpy arrays (tensors on the solve's device
    under ``device_results=True``).  ``losses`` has length ``n_iter``.  The
    fields and their order are the JAX package's.
    """

    W: np.ndarray
    H: np.ndarray
    losses: List[float]
    time_elapsed: float
    n_iter: int
    converged: bool
    best_restart: int = 0
    all_final_losses: Optional[np.ndarray] = None
    seed: Optional[int] = None
    extras: dict = field(default_factory=dict)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return getattr(dtype, "name", None) or np.dtype(dtype).name


def _resolve_dtype(dtype):
    """``(compute dtype, data dtype)``: ``None`` is float32; float32 and
    float64 compute and store in themselves (data dtype ``None``);
    ``"bfloat16"`` (a name, ``torch.bfloat16`` or a numpy spelling) is the
    bf16-data mode, float32 compute over data stored bf16.  Accepts torch
    dtypes, numpy dtypes and names."""
    name = "float32" if dtype is None else _dtype_name(dtype)
    if name == "bfloat16":
        return torch.float32, torch.bfloat16
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32, float64 or bfloat16, got {dtype!r}")
    return getattr(torch, name), None


def _resolve_backend(backend: str, dtype: torch.dtype, device: torch.device, binary: bool,
                     packed: Optional[bool] = None, k: Optional[int] = None) -> str:
    """Pick the solver loop: ``"fused"`` or ``"plain"``.

    ``"jnp"`` and ``"pallas"``, the JAX package's names, stand for
    ``"plain"`` and ``"fused"``.  ``"auto"`` takes the fused kernel loop for
    float32 on a CUDA device and the plain loop for float64, on the CPU, or
    for a rank ``k`` above the kernels' cap (``cuda_sweep.MAX_RANK``);
    ``"fused"`` with such a rank raises here, before anything is staged.  The
    fused loop streams packed words when the operands are exactly binary
    (``binary``) and ``packed`` is not False, dense operands otherwise.  ``packed=True``
    demands the packed words: it raises for non-binary operands and for the
    plain loop, as the JAX package's ``solve`` does.
    """
    backend = canonical_backend(backend)
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS} (or the JAX package's "
                         f"{tuple(_BACKEND_ALIASES)}), got {backend!r}")
    if packed not in (None, False, True):
        raise ValueError(f"packed must be None, False or True, got {packed!r}")
    if backend == "fused" and device.type == "cuda" and dtype != torch.float32:
        raise ValueError("backend='fused' on a CUDA device requires dtype=float32")
    over_cap = k is not None and k > cs.MAX_RANK
    if backend == "fused" and over_cap:
        raise ValueError(f"backend='fused' takes ranks up to {cs.MAX_RANK} (the kernels' cap), "
                         f"got k={k}; use backend='auto' or 'plain'")
    if backend == "fused" or (backend == "auto" and dtype == torch.float32
                              and device.type == "cuda" and not over_cap):
        route = "fused"
    else:
        route = "plain"
    if packed is True:
        if route == "plain":
            raise ValueError("packed=True requires the fused loop (backend='fused', or 'auto' "
                             "resolving to it: float32 on a CUDA device)")
        if not binary:
            raise ValueError("packed=True requires exactly binary data (and mask)")
    return route


def _exactly_binary(A: Optional[torch.Tensor]) -> bool:
    """True when every entry of ``A`` is exactly 0 or 1 (None counts as
    binary): the eligibility rule for the bit-packed loop."""
    if A is None:
        return True
    with span("nbmf_mm.wait.binary_scan"):
        return bool(((A == 0) | (A == 1)).all())


def _resolve_precision(precision, data_dtype=None) -> str:
    """The product tier (``ops.tiers``): ``None``, ``"default"``, ``"high"``
    or ``"highest"`` in any case, ``None`` being ``"highest"``; other values
    raise ``ValueError``.  The bf16-data mode forces ``"default"``, as in the
    JAX package."""
    tier = tiers.resolve_tier(precision)
    return "default" if data_dtype == torch.bfloat16 else tier


def _random_uniform_inits(seed: int, n_init: int, m: int, n: int, k: int, dtype):
    """Reference-style U(0.1, 0.9) initialization (``_solver.py:126-129``),
    batched over ``n_init`` restarts: ``W0 (n_init, m, k)`` drawn first, then
    ``H0 (n_init, k, n)``, from a CPU generator, so that a seed gives the same
    numbers wherever the solve runs.  With ``n_init == 1`` they are the draws
    of a single fit."""
    gen = torch.Generator().manual_seed(seed)
    W0 = torch.rand((n_init, m, k), generator=gen, dtype=dtype) * 0.8 + 0.1
    H0 = torch.rand((n_init, k, n), generator=gen, dtype=dtype) * 0.8 + 0.1
    return W0, H0


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float))


def _prior_minus_one(x, lead, dtype: torch.dtype, device: torch.device):
    """``x - 1`` for a prior parameter: a float stays a float; one value per
    lane becomes a tensor of shape ``lead`` in the compute dtype on
    ``device``, subtracted in float64 first, so that a lane computes with
    exactly the number a float argument would give it."""
    if _is_scalar(x):
        return float(x) - 1.0
    values = torch.as_tensor(x, dtype=torch.float64).reshape(lead) - 1.0
    return values.to(device=device, dtype=dtype)


def _over_factor(x):
    """A per-lane value broadcast over the lanes' ``(k, n)`` factors."""
    return x[..., None, None] if isinstance(x, torch.Tensor) else x


def _relative_change(prev: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
    """The reference's stopping measure (``_solver.py:169-175``); NaN, which
    is below no tolerance, while ``prev`` is infinite."""
    return torch.abs(prev - loss) / torch.abs(prev)


def _loop_state(W0: torch.Tensor, max_iter: int):
    """``(lead, losses, prev, done, n_iter)`` at the start of a loop over
    factors with leading lane axes ``lead`` (none for one initialization)."""
    lead = tuple(W0.shape[:-2])
    kw = dict(dtype=W0.dtype, device=W0.device)
    return (lead, torch.zeros((*lead, max_iter), **kw), torch.full(lead, float("inf"), **kw),
            torch.zeros(lead, dtype=torch.bool, device=W0.device),
            torch.zeros(lead, dtype=torch.int64, device=W0.device))


def _keep_frozen(done, W, H, W_new, H_new, lead):
    """The swept factors, with the lanes that are ``done`` left as they were.
    One initialization has no frozen state to keep (its loop ends when it is
    done), so it takes the new factors without a select or a copy."""
    if not lead:
        return W_new, H_new
    frozen = _over_factor(done)
    return torch.where(frozen, W, W_new), torch.where(frozen, H, H_new)


def _loop_result(W, H, losses, n_iter, final_loss, done, lead):
    """The cores' return: per-lane tensors for a batch, and for one
    initialization ``n_iter`` and ``done`` as an int and a bool."""
    if lead:
        return W, H, losses, n_iter, final_loss, done
    with span("nbmf_mm.wait.result"):
        return W, H, losses, int(n_iter), final_loss, bool(done)


def _solve_core(Ym, Ym2, Yc, W0, H0, alpha, beta, tol, eps, n_obs, n_real, *,
                max_iter: int, projection: str, verbose: int, precision=None):
    """Plain MM loop (internal beta-dir layout: ``W0`` is ``(k, m)`` with
    unit column sums, ``H0`` is ``(k, n)``), the counterpart of the JAX
    ``_solve_core``/``_mm_loop``, with the same positional arguments;
    ``precision`` is the tier of every product.

    ``W0 (R, k, m)`` with ``H0 (R, k, n)`` solves ``R`` lanes in lockstep
    over the same data, ``alpha``/``beta`` floats or one value per lane; a
    lane that has converged is frozen by selects (its stopping sweep's
    update is kept, as in ``_mm_loop``) while the loop runs on until every
    lane has stopped or ``max_iter`` is reached.

    Returns ``(W, H, losses, n_iter, final_loss, done)`` with ``losses`` a
    ``(max_iter,)`` buffer per lane whose entries past ``n_iter`` are zero;
    ``n_iter``, ``final_loss`` and ``done`` are per-lane tensors for a batch
    (an int, a 0-d tensor and a bool for one initialization).
    """
    lead, losses, prev, done, n_iter = _loop_state(W0, max_iter)
    if not _is_scalar(alpha):  # one host copy, read lane by lane
        alpha = torch.as_tensor(alpha, dtype=torch.float64).reshape(lead).cpu().numpy()
    if not _is_scalar(beta):
        beta = torch.as_tensor(beta, dtype=torch.float64).reshape(lead).cpu().numpy()
    with span("nbmf_mm.loop"):
        W, H = W0, H0
        it, all_done = 0, False
        check_nan = debugging.nan_checks_enabled()
        while it < max_iter and not all_done:
            with span("nbmf_mm.sweep"):
                W_new, H_new = mm_sweep(W, H, Ym, Ym2, Yc, alpha=alpha, beta=beta,
                                        n_real=n_real, eps=eps, projection=projection,
                                        precision=precision)
                loss = map_objective(W_new, H_new, Ym, Yc, alpha=alpha, beta=beta, n_obs=n_obs,
                                     eps=eps, precision=precision)
                if check_nan:
                    debugging.check_finite("plain loop", it, W=W_new, H=H_new, loss=loss)
                if verbose > 0 and not lead and it % 10 == 0:
                    print(f"Iter {it}: Loss = {float(loss)}")
                # The stopping sweep's update and loss are kept (len(losses) ==
                # n_iter); a lane frozen earlier keeps its carry.
                W, H = _keep_frozen(done, W, H, W_new, H_new, lead)
                losses[..., it] = torch.where(done, losses[..., it], loss)
                newly_done = (_relative_change(prev, loss) < tol) if it > 0 else False
                prev = torch.where(done, prev, loss)
                n_iter = torch.where(done, n_iter, it + 1)
                done = done | newly_done
                it += 1
                if it > 1:
                    with span("nbmf_mm.wait.stop_flag"):  # the sweep's one host read
                        all_done = bool(done.all())
        return _loop_result(W, H, losses, n_iter, prev, done, lead)


def _solve_core_fused(Y1, Y2_h, Y2_w, W0p, H0p, alpha, beta, tol, n_obs, *, packed: bool, eps,
                      m_real: int, n_real: int, bm: int, max_iter: int, projection: str,
                      verbose: int, mxu_precision=None):
    """Shifted-loss MM loop of the H and W kernels (``_solve_core_pallas``,
    with its positional arguments).

    The loss the reference reports after sweep ``t`` is evaluated on the same
    ``W.T @ H`` that the next sweep's H pass forms, so both come out of one
    H-pass call: the body at counter ``it`` records the loss of sweep
    ``it-1`` and makes the stopping decision the reference made before sweep
    ``it``.  When ``max_iter`` runs out, one more pass fills the last entry:
    the packed H pass, or ``loglik_sum`` on dense operands, as the JAX tiled
    route does (its ``ll`` is the dense H pass's, bitwise).

    ``packed`` selects the operand set: int32 words (``Y1`` packs ``Ym``)
    or dense f32 (``Y1`` is ``Ym``), or dense bf16 in the bf16-data mode.
    ``mxu_precision`` is the kernels' product tier (``ops.tiers``); bf16
    operands run the bf16-data instances whatever it says.  ``Y2_h`` is the H pass's second
    operand (corrected mode's ``Yc``, else None), ``Y2_w`` the W pass's
    (``Ym2`` in both masked modes, else None); in corrected mode they are one
    buffer.  Operands are padded to ``(Mp, Np)``; results come back padded.

    ``W0p (R, k, Mp)`` with ``H0p (R, k, Np)`` solves ``R`` lanes in lockstep:
    each kernel call carries all lanes over the one copy of the data,
    ``alpha``/``beta`` are floats or one value per lane, and a lane whose
    stopping test has fired keeps its factors, its counter and its last
    recorded loss by selects (``_solve_core_pallas``'s ``done_out``) while
    the others run on; frozen lanes still go through the kernels.  The loop
    ends when every lane has stopped or ``max_iter`` is reached, and the
    fill is selected per lane.  Returns as :func:`_solve_core`.
    """
    dtype, device = W0p.dtype, W0p.device
    lead, losses, prev, done, n_iter = _loop_state(W0p, max_iter)
    am1 = _prior_minus_one(alpha, lead, dtype, device)
    bm1 = _prior_minus_one(beta, lead, dtype, device)
    upper = clip_upper_interior(eps, dtype)
    h_pass = cs.hloss_terms_packed if packed else ds.hloss_terms
    w_pass = cs.w_terms_packed if packed else ds.w_terms

    tier = dict(precision=mxu_precision)

    def hloss(W, H):
        return h_pass(W, H, Y1, Y2_h, eps=eps, m_real=m_real, n_real=n_real, bm=bm, **tier)

    def final_ll(W, H):
        if packed:
            return hloss(W, H)[2]
        return ds.loglik_sum(W, H, Y1, Y2_h, eps=eps, m_real=m_real, n_real=n_real, bm=bm,
                             **tier)

    def objective_from_ll(ll, H):
        H_real = H[..., :n_real]
        prior_a = am1 * torch.sum(torch.log(H_real + eps), dim=(-2, -1))
        prior_b = bm1 * torch.sum(torch.log(1.0 - H_real + eps), dim=(-2, -1))
        return -(ll + prior_a + prior_b) / n_obs

    def finish_sweep(W, H, Num, Den):
        num = H * Num + _over_factor(am1)
        den = (1.0 - H) * Den + _over_factor(bm1)
        H_new = cs.apply_col_validity(torch.clamp(num / (num + den + eps), eps, upper), n_real)
        T = w_pass(W, H_new, Y1, Y2_w, eps=eps, n_real=n_real, bm=bm, **tier)
        W_raw = W * T
        if projection == "normalize":
            W_new = W_raw / n_real
            col_sums = W_new.sum(dim=-2, keepdim=True)
            W_new = W_new / torch.where(col_sums > 0, col_sums, 1.0)
        else:  # duchi: re-zero the pad columns the projection would fill
            W_new = cs.apply_col_validity(project_simplex_duchi(W_raw / n_real, dim=-2), m_real)
        return W_new, H_new

    with span("nbmf_mm.loop"):
        W, H = W0p, H0p
        it, all_done = 0, False
        check_nan = debugging.nan_checks_enabled()
        while it < max_iter:
            with span("nbmf_mm.sweep"):
                Num, Den, ll = hloss(W, H)
                if it >= 1:
                    loss = objective_from_ll(ll, H)  # loss of sweep it-1
                    if check_nan:
                        debugging.check_finite("fused loop", it - 1, loss=loss)
                    if verbose > 0 and not lead and (it - 1) % 10 == 0:
                        print(f"Iter {it - 1}: Loss = {float(loss)}")
                    live = ~done
                    losses[..., it - 1] = torch.where(live, loss, losses[..., it - 1])
                    if it >= 2:  # the stopping test needs two recorded losses
                        done = done | (_relative_change(prev, loss) < tol)
                        with span("nbmf_mm.wait.stop_flag"):  # the sweep's one host read
                            all_done = bool(done.all())
                    prev = torch.where(live, loss, prev)
                    if all_done:
                        break
                W, H = _keep_frozen(done, W, H, *finish_sweep(W, H, Num, Den), lead)
                if check_nan:
                    debugging.check_finite("fused loop", it, W=W, H=H)
                n_iter = torch.where(done, n_iter, it + 1)
                it += 1

        final_loss = prev
        if not all_done:
            # max_iter ran out for the live lanes: their last sweep's loss was
            # never recorded.  Their counters stand at ``it``.
            loss_fin = objective_from_ll(final_ll(W, H), H)
            live, last = ~done, max(it - 1, 0)
            if check_nan:
                debugging.check_finite("fused loop", last, loss=loss_fin)
            losses[..., last] = torch.where(live, loss_fin, losses[..., last])
            final_loss = torch.where(live, loss_fin, prev)
            if it >= 2:
                done = done | (live & (_relative_change(prev, loss_fin) < tol))
        return _loop_result(W, H, losses, n_iter, final_loss, done, lead)


def _renormalize_drifted(A: torch.Tensor, dim: int) -> torch.Tensor:
    """Divide ``A`` by its sums along ``dim`` where they drifted more than
    1e-9 from 1 (all-zero slices stay as they are).  Only the drift, one
    scalar, is read back to the host."""
    tiny, tol = 1e-12, 1e-9
    if A.numel() == 0:
        return A
    sums = A.sum(dim=dim, keepdim=True)
    with span("nbmf_mm.wait.drift"):
        drift = float((sums - 1.0).abs().max())
    if np.isfinite(drift) and drift > tol:
        safe = sums > tiny
        A = torch.where(safe, A / torch.where(safe, sums, 1.0), A)
    return A


def _final_simplex_safeguard(W_final, H_final, orientation):
    """Renormalization safeguard replicating ``_solver.py:186-213``: if the
    simplex factor drifted from unit sums, renormalize it.  Tensors in and
    out, on their device."""
    if orientation == "beta-dir":
        return _renormalize_drifted(W_final, 1), H_final
    return W_final, _renormalize_drifted(H_final, 0)


def _is_scipy_sparse(A) -> bool:
    """A scipy.sparse matrix or array (scipy is imported only for an object
    that has ``toarray``)."""
    if isinstance(A, (np.ndarray, torch.Tensor)) or not hasattr(A, "toarray"):
        return False
    import scipy.sparse as sp

    return sp.issparse(A)


def _to_tensor(A, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A dense operand as a tensor of ``dtype`` on ``device``: the compute
    dtype, or bf16 for the data of the bf16-data mode, which crosses as
    float32 and is cast on ``device`` (the float32 copy is dropped on
    return)."""
    if isinstance(A, torch.Tensor):
        return A.to(device=device, dtype=dtype)
    if hasattr(A, "toarray"):
        A = A.toarray()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.as_tensor(np.asarray(A, dtype=np_dtype), device=device).to(dtype)


def _pad(A: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(A, (0, cols - A.shape[1], 0, rows - A.shape[0])).contiguous()


def _pad_last(A: torch.Tensor, cols: int) -> torch.Tensor:
    """Zero-pad the last axis of a batch of factors to ``cols``."""
    return torch.nn.functional.pad(A, (0, cols - A.shape[-1])).contiguous()


def _internal_simplex_factor(W_ext: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One external ``(m, k)`` init in the internal layout on ``device``:
    ``(k, m)`` with unit column sums.  Zero columns (a returned factor's
    fully-unobserved samples) stay zero instead of 0/0."""
    W0 = W_ext.T.to(device)
    W0_sums = W0.sum(dim=0, keepdim=True)
    return (W0 / torch.where(W0_sums > 0, W0_sums, 1.0)).contiguous()


def _masked_operands(Y, mask):
    """``(Ym, Ym2)``: ``Y`` or ``Y * mask``, and ``(1 - Y) * mask`` when
    masked, on numpy arrays or tensors alike."""
    if mask is None:
        return Y, None
    return Y * mask, (1.0 - Y) * mask


def _stage_dense(Y: torch.Tensor, mask: Optional[torch.Tensor], *, Mp: int, Np: int, bm: int,
                 packed: Optional[bool]):
    """Stage dense operands on their device for the fused loop: ``(Y1, Y2,
    use_packed)``, words when ``Ym``/``Ym2`` are exactly binary and
    ``packed`` allows it, else the padded dense operands.  Packing needs them
    exactly 0/1 after masking, so values at unobserved entries do not matter.
    bf16 ``Y`` and ``mask`` (the bf16-data mode, cast before this) are never
    packed: ``Ym = Y * mask`` and ``Ym2 = (1 - Y) * mask`` are formed in bf16,
    as in the JAX package, and padded as they are.

    Host input reaches this as a plain copy of the dense operands: copying
    float32 and packing on the card beat packing on the host and copying
    uint8 on an H100 (``PERF.md``, section 5; ``chip_smoke.py`` times the
    three).
    """
    Ym, Ym2 = _masked_operands(Y, mask)
    use_packed = (packed is not False and Y.dtype != torch.bfloat16 and _exactly_binary(Ym)
                  and _exactly_binary(Ym2))
    stage = (lambda A: cs.pack_bits(_pad(A, Mp, Np), bm)) if use_packed else (
        lambda A: _pad(A, Mp, Np))
    return stage(Ym), None if Ym2 is None else stage(Ym2), use_packed


def _check_packed_contract(*, orientation, mask, packed, dtype, data_dtype=None) -> None:
    """What the words of a :class:`PackedMatrix` cannot express."""
    if orientation != "beta-dir":
        raise ValueError("PackedMatrix input supports orientation='beta-dir' only "
                         "(pack the transposed matrix for dir-beta)")
    if mask is not None:
        raise ValueError("PackedMatrix input does not take a separate mask")
    if packed is False:
        raise ValueError("packed=False contradicts a PackedMatrix input")
    if data_dtype == torch.bfloat16:
        raise ValueError("PackedMatrix input requires float32 compute (the packed kernels "
                         "are float32; got dtype='bfloat16')")
    if dtype != torch.float32:
        raise ValueError("PackedMatrix input requires float32 compute (the packed kernels "
                         f"are float32; got dtype={dtype})")


def _check_packed_words(pm: PackedMatrix, route: str) -> None:
    """Check that the words of a :class:`PackedMatrix` can be the staged
    operand: the fused loop runs, and they were packed for the geometry
    ``solve`` plans (stripe-local bit planes only combine with the same
    ``block_m``)."""
    if route != "fused":
        raise ValueError("PackedMatrix input requires the fused loop (backend='fused', or "
                         "'auto' resolving to it: float32 on a CUDA device at a rank up to "
                         f"{cs.MAX_RANK})")
    m, n = pm.shape
    bm, Mp, Np = cs.plan_packing(m, n)
    if (pm.block_m != bm or tuple(pm.padded_shape) != (Mp, Np)
            or pm.words.dtype != torch.int32):
        raise ValueError(
            f"PackedMatrix(block_m={pm.block_m}, padded {tuple(pm.padded_shape)}, "
            f"{pm.words.dtype}) does not match the geometry planned for {(m, n)}: "
            f"block_m={bm}, padded {(Mp, Np)}, int32 words; rebuild it with pack_matrix")


def _route_sparse(Y, mask, *, eligible: bool, packed: Optional[bool], device: torch.device):
    """Route scipy.sparse data: ``(Y, mask, sparse_masked)``.

    When the solve runs the packed fused loop anyway (``eligible``), binary
    data without a mask packs straight from its structure into a
    :class:`PackedMatrix`, and binary data under a binary scipy.sparse mask
    comes back as the pair of canonical CSRs (``sparse_masked``), whose
    operands ``solve`` packs.  Everything else (another routing, stored
    values other than 0 and 1) densifies and gives the dense-input result,
    unless ``packed=True`` demanded the words."""
    if eligible and mask is None:
        try:
            return pack_matrix_sparse(Y, device=device), None, False
        except ValueError:
            if packed is True:
                raise
    elif eligible and _is_scipy_sparse(mask):
        Yb, Mb = csr_binary_canonical(Y), csr_binary_canonical(mask)
        if Yb is not None and Mb is not None:
            return Yb, Mb, True
        if packed is True:
            raise ValueError("packed=True with sparse data and a sparse mask requires "
                             "exactly binary stored values")
    return Y.toarray(), mask, False


def _results(W, H, losses, *, device_results: bool):
    """External factors and losses as they are returned: tensors on their
    device, or numpy arrays and a list of floats."""
    if device_results:
        return W, H, losses
    return W.cpu().numpy(), H.cpu().numpy(), [float(x) for x in losses.cpu().numpy()]


@ieee_fp32_products()
def solve(
    Y,
    n_components: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    alpha: float = 1.2,
    beta: float = 1.2,
    W_init=None,
    H_init=None,
    mask=None,
    random_state: Optional[int] = None,
    verbose: int = 0,
    orientation: str = "beta-dir",
    eps: float = 1e-8,
    *,
    n_init: int = 1,
    projection: str = "normalize",
    mask_mode: str = "parity",
    dtype=None,
    precision=None,
    mesh=None,
    mesh_axes: Tuple[str, str] = ("rows", "cols"),
    backend: str = "auto",
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    pallas_interpret: bool = False,
    packed: Optional[bool] = None,
    return_all: bool = False,
    device_results: bool = False,
    device="cuda",
) -> SolverResult:
    """Solve ``Y ~ Bernoulli(W @ H)`` by MM and return a :class:`SolverResult`.

    Semantics mirror the JAX package's ``solve`` for the options this package
    supports:

    - ``Y``: a dense array or tensor; a ``scipy.sparse`` matrix; or a
      :class:`~nbmf_mm_tpu_torch.ops.packed.PackedMatrix`, whose words are
      the staged operand (beta-dir, no separate mask, float32, the fused loop
      only; its geometry must be the one ``pack_matrix`` plans).  Binary
      sparse data packs straight from its structure when the solve runs the
      packed fused loop anyway (beta-dir, float32, ``packed`` not False, no
      mask or a binary ``scipy.sparse`` mask); on every other routing it
      densifies.  All of these give the dense-input result bitwise;
    - ``orientation``: ``"beta-dir"`` or ``"dir-beta"`` (solved as beta-dir on
      ``Y.T``; a custom init then needs both factors);
    - ``mask`` with ``mask_mode`` ``"parity"`` or ``"corrected"``; an all-zero
      mask raises;
    - ``projection``: ``"normalize"`` or ``"duchi"``;
    - ``W_init``/``H_init``, renormalized with the zero-column guard;
      ``max_iter=0`` returns the (first restart's) initial factors untouched;
    - ``n_init``: that many random restarts as one batched solve over data
      staged once, on every data route (dense, ``PackedMatrix``, sparse): the
      lanes share each kernel launch, and the restart with the lowest final
      objective is returned (the first on a tie; a NaN counts as lowest, as
      in the JAX package), with ``best_restart`` and ``all_final_losses``
      filled.  It excludes custom inits and prints no per-sweep losses;
    - ``return_all`` (needs ``n_init > 1``): every restart in ``extras`` as
      host numpy arrays, ``all_W (n_init, m, k)``, ``all_H (n_init, k, n)``,
      ``all_n_iter``, ``all_losses (n_init, max_iter)`` and ``all_converged``
      (also under ``device_results``);
    - ``dtype``: float32 (default), float64, or ``"bfloat16"`` (also
      ``torch.bfloat16`` or a numpy spelling): the bf16-data mode of the JAX
      package.  Factors, updates and losses stay float32; only the data
      operands ``Ym``, ``Ym2``, ``Yc`` are stored bf16 on the device, cast
      before they are masked and padded, and the kernels round every product
      operand to bf16 (the tier is ``"default"``).  It is never packed, even
      for binary data; ``packed=True`` or a ``PackedMatrix`` with it raise
      ``ValueError``.  The plain loop keeps the data float32 and runs its
      products at ``"default"``.  ``extras["data_dtype"]`` records it;
    - ``precision``: the product tier (``ops.tiers`` defines them).
      ``None`` or ``"highest"``: IEEE fp32 products (TF32 is off inside the
      call and the caller's settings are restored on exit).  ``"high"``:
      each operand of each product rounded to TF32 (10-bit mantissa,
      nearest, ties away from zero).  ``"default"``: each operand rounded to
      bf16 (nearest even).  Products accumulate in fp32 in every tier, on
      every route: the kernels, their plain versions and the plain loop.
      ``None`` stays ``"highest"`` here (the JAX package's Pallas path
      defaults to DEFAULT).  The rounding is explicit, so a tier gives the
      same numbers on the CPU as on the card up to summation order, where the
      JAX package on the CPU computes every tier in fp32.
      ``extras["precision"]`` records a tier other than ``"highest"``;
    - ``device``: an explicit ``torch.device`` (default ``"cuda"``, which
      raises on a machine without a GPU; nothing moves to the CPU unasked);
    - ``backend``: ``"auto"``, ``"fused"`` (the kernel loop; CPU tensors go
      through the kernels' plain versions) or ``"plain"`` (dense
      ``mm_sweep`` loop), see :func:`_resolve_backend`; the JAX package's
      ``"pallas"`` and ``"jnp"`` are the same loops under those names;
    - ``block_m``/``block_n``: the JAX package's Pallas tile sizes, accepted
      and ignored: the port plans its own tiling (``cs.plan_packing`` and
      the kernels' split planners);
    - ``pallas_interpret``: ``True`` is what CPU tensors do anyway (the
      kernels' plain versions); on a CUDA device it raises ``ValueError``;
    - ``packed``: ``None`` streams exactly-binary operands (data, and mask
      if given) as packed words and all others dense; ``False`` streams
      dense; ``True`` requires binary operands and the fused loop, and
      raises otherwise.  Packed and dense results are bitwise equal.
      ``extras["packed"]`` records the choice;
    - ``device_results``: return ``W``, ``H`` and ``losses`` as tensors on
      ``device``; only ``n_iter``, ``converged`` and the safeguard's drift
      are read back to the host.

    ``mesh`` raises ``NotImplementedError``; ``mesh_axes`` is checked only
    with it.
    """
    with span("nbmf_mm.solve"):
        with span("nbmf_mm.stage"):
            if orientation not in _ORIENTATIONS:
                raise ValueError(f"orientation must be one of {_ORIENTATIONS}, "
                                 f"got {orientation!r}")
            if projection not in ("normalize", "duchi"):
                raise ValueError(f"projection must be 'normalize' or 'duchi', "
                                 f"got {projection!r}")
            if mask_mode not in ("parity", "corrected"):
                raise ValueError(f"mask_mode must be 'parity' or 'corrected', "
                                 f"got {mask_mode!r}")
            if n_init < 1:
                raise ValueError(f"n_init must be >= 1, got {n_init}")
            _check_mesh(mesh, mesh_axes, "mesh")
            dtype, data_dtype = _resolve_dtype(dtype)
            tier = _resolve_precision(precision, data_dtype)
            device = cs.resolve_device(device)
            _check_interpret(pallas_interpret, device)
            k = int(n_components)
            if type(Y).__name__ == "PackedMatrix" and not isinstance(Y, PackedMatrix):
                raise TypeError(
                    f"{type(Y).__module__}.PackedMatrix is another package's: convert its "
                    "words with nbmf_mm_tpu_torch.utils.interop.packed_from_reference"
                )
            if isinstance(Y, PackedMatrix):
                _check_packed_contract(orientation=orientation, mask=mask, packed=packed,
                                       dtype=dtype, data_dtype=data_dtype)
            route = _resolve_backend(backend, dtype, device, True, packed, k)
            if packed is True and data_dtype is not None:
                raise ValueError("packed=True is incompatible with dtype='bfloat16': packing "
                                 "replaces the data stream (and is both smaller and exact)")
            # The data is stored bf16 for the kernels; the plain loop keeps it in the
            # compute dtype and runs its products at DEFAULT (the JAX package's XLA
            # emulation of the mode).
            data_dtype = data_dtype if route == "fused" else None

            t_start = time.perf_counter()
            sparse_masked = False  # Y and mask as canonical binary CSRs
            if _is_scipy_sparse(Y):
                eligible = (orientation == "beta-dir" and packed is not False
                            and data_dtype is None and dtype == torch.float32
                            and route == "fused")
                Y, mask, sparse_masked = _route_sparse(Y, mask, eligible=eligible,
                                                       packed=packed, device=device)
            words = isinstance(Y, PackedMatrix)
            if words:
                _check_packed_words(Y, route)
            elif not sparse_masked:
                # bf16 data is cast before it is masked or padded, so that no
                # full-size float32 copy lingers.
                Y = _to_tensor(Y, data_dtype or dtype, device)
                if mask is not None:
                    mask = _to_tensor(mask, data_dtype or dtype, device)

            transposed = orientation == "dir-beta"
            if transposed:
                Y = Y.T
                if mask is not None:
                    mask = mask.T
                if (W_init is None) != (H_init is None):
                    raise ValueError(
                        "orientation='dir-beta' with a custom init requires BOTH W_init and "
                        "H_init"
                    )
                if W_init is not None:
                    W_init, H_init = np.asarray(H_init).T, np.asarray(W_init).T

            m, n = Y.shape
            seed = (int(np.random.SeedSequence().entropy % (2**63)) if random_state is None
                    else int(random_state))

            custom_init = W_init is not None or H_init is not None
            if custom_init and n_init > 1:
                raise ValueError("n_init > 1 is incompatible with explicit W_init/H_init")
            # U(0.1, 0.9) inits with a leading restart axis, then moved to the device.
            with span("nbmf_mm.init_draw"):
                W0_ext, H0 = _random_uniform_inits(seed, n_init, m, n, k, dtype)
            if W_init is not None:
                W0_ext = torch.tensor(np.asarray(W_init), dtype=dtype)[None]
            if H_init is not None:
                H0 = torch.tensor(np.asarray(H_init), dtype=dtype)[None]
            if tuple(W0_ext.shape[1:]) != (m, k):
                raise ValueError(f"W_init must have shape {(m, k)}, "
                                 f"got {tuple(W0_ext.shape[1:])}")
            if tuple(H0.shape[1:]) != (k, n):
                raise ValueError(f"H_init must have shape {(k, n)}, got {tuple(H0.shape[1:])}")
            with span("nbmf_mm.init_copy"):
                # (n_init, k, m) and (n_init, k, n); the fused loop takes them padded
                W0 = torch.stack([_internal_simplex_factor(w, device) for w in W0_ext])
                H0 = H0.to(device).contiguous()
                if route == "fused":
                    bm, Mp, Np = cs.plan_packing(m, n)
                    inits = (_pad_last(W0, Mp), _pad_last(H0, Np))
                else:
                    inits = (W0, H0)

            if mask is None:
                n_obs = float(m * n)
            else:
                # A canonical binary CSR is counted by its stored nonzeros, never
                # from a dense copy.
                with span("nbmf_mm.wait.n_obs"):
                    n_obs = float(mask.count_nonzero() if sparse_masked
                                  else torch.count_nonzero(mask))
                if n_obs == 0.0:
                    raise ValueError(
                        "mask has no observed entries (all zeros): the per-entry "
                        "objective is undefined with n_obs == 0"
                    )

            if return_all and n_init <= 1:
                raise ValueError("return_all requires n_init > 1")

            if max_iter <= 0:
                # The first restart's factors, as the JAX package returns them.
                W_final, H_final = (H0[0].T, W0[0]) if transposed else (W0[0].T, H0[0])
                W_final, H_final, losses = _results(
                    W_final, H_final, torch.zeros(0, dtype=dtype, device=device),
                    device_results=device_results)
                return SolverResult(W=W_final, H=H_final, losses=losses,
                                    time_elapsed=time.perf_counter() - t_start, n_iter=0,
                                    converged=False, seed=seed)

            # One initialization solves unbatched; restarts go through the same core
            # with a leading lane axis on the factors, and print nothing per sweep.
            loop = dict(max_iter=max_iter, projection=projection,
                        verbose=verbose if n_init == 1 else 0)
            with span("nbmf_mm.operands"):
                if route == "fused":
                    # The operands the kernels stream (the JAX package's
                    # driver.py:957-977): Y1 = Ym = Y or Y*mask, Y2 = Ym2 =
                    # (1-Y)*mask when masked; corrected mode's Yc is Ym2 itself.
                    if words:
                        Y1, Y2, use_packed = Y.words.to(device).contiguous(), None, True
                    elif sparse_masked:
                        # Both operands are sparse too: Ym = Y*mask, Ym2 = mask - Ym,
                        # each packed from row chunks, one transient uint8 chunk at a
                        # time.
                        Ym = Y.astype(np.int8).multiply(mask.astype(np.int8)).tocsr()
                        Ym2 = (mask.astype(np.int8) - Ym).tocsr()
                        Y1, Y2 = (torch.from_numpy(pack_sparse_words(A, Mp, Np, bm)).to(device)
                                  for A in (Ym, Ym2))
                        use_packed = True
                        del Ym, Ym2
                    else:
                        Y1, Y2, use_packed = _stage_dense(Y, mask, Mp=Mp, Np=Np, bm=bm,
                                                          packed=packed)
                        if packed is True and not use_packed:
                            raise ValueError("packed=True requires exactly binary data "
                                             "(and mask)")
                    del Y, mask
                    core = partial(_solve_core_fused, packed=use_packed, eps=eps, m_real=m,
                                   n_real=n, bm=bm, mxu_precision=tier, **loop)
                    data = (Y1, Y2 if mask_mode == "corrected" else None, Y2)
                    hypers = (alpha, beta, tol, n_obs)
                else:
                    use_packed = False
                    core = partial(_solve_core, precision=tier, **loop)
                    data = precompute_masked_terms(Y, mask, mask_mode)
                    hypers = (alpha, beta, tol, eps, n_obs, n)

        all_results = all_final = None
        if n_init == 1:
            best = 0
            W, H, losses, n_iter, _, done = core(*data, inits[0][0], inits[1][0], *hypers)
        else:
            from ..parallel.restarts import vmapped_solve  # the package imports this module

            (W, H, losses, n_iter, _, done), best, all_final, all_results = vmapped_solve(
                core, data, inits, hypers, keep_all=return_all)
            with span("nbmf_mm.wait.result"):
                n_iter, done, all_final = int(n_iter), bool(done), all_final.cpu().numpy()

        with span("nbmf_mm.finish"):
            W, H = W[:, :m], H[:, :n]  # the fused loop's results come back padded

            W_final, H_final = (H.T, W) if transposed else (W.T, H)  # external (m, k), (k, n)
            W_final, H_final = _final_simplex_safeguard(W_final, H_final, orientation)
            if verbose > 0 and done and n_iter < max_iter:
                print(f"Converged at iteration {n_iter - 1}")
            W_final, H_final, losses = _results(W_final, H_final, losses[:n_iter],
                                                device_results=device_results)
            result = SolverResult(
                W=W_final,
                H=H_final,
                losses=losses,
                time_elapsed=time.perf_counter() - t_start,
                n_iter=n_iter,
                converged=done,
                best_restart=best,
                all_final_losses=all_final,
                seed=seed,
                extras=_extras(route, use_packed, tier, data_dtype),
            )
            if all_results is not None:
                _attach_all_results(result, all_results, m=m, n=n, transposed=transposed)
            return result


def _extras(route: str, packed: bool, tier: str, data_dtype) -> dict:
    """``SolverResult.extras``: the loop and whether it streamed words, then
    the product tier and the stored data dtype where they are not the
    defaults (``"highest"``, the compute dtype)."""
    extras = {"backend": route, "packed": packed}
    if tier != "highest":
        extras["precision"] = tier
    if data_dtype is not None:
        extras["data_dtype"] = str(data_dtype).removeprefix("torch.")
    return extras


def _attach_all_results(result: SolverResult, all_results, *, m: int, n: int,
                        transposed: bool) -> None:
    """Fill ``result.extras`` with every restart's factors and trace (the
    ``return_all`` contract), as host numpy arrays in external notation."""
    aW, aH, a_losses, a_n_iter, _, a_done = (x.cpu().numpy() for x in all_results)
    all_W = np.swapaxes(aW[:, :, :m], 1, 2)  # internal (n_init, k, Mp) -> (n_init, m, k)
    all_H = aH[:, :, :n]
    if transposed:
        all_W, all_H = np.swapaxes(all_H, 1, 2), np.swapaxes(all_W, 1, 2)
    result.extras.update(all_W=all_W, all_H=all_H, all_n_iter=a_n_iter, all_losses=a_losses,
                         all_converged=a_done)


def nbmf_mm_solver(
    Y,
    n_components: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    alpha: float = 1.2,
    beta: float = 1.2,
    W_init=None,
    H_init=None,
    mask=None,
    random_state: Optional[int] = None,
    verbose: int = 0,
    orientation: str = "beta-dir",
    eps: float = 1e-8,
    **kwargs,
):
    """Reference-style tuple API: ``(W, H, losses, time_elapsed, n_iter)``.
    Extra keyword arguments are forwarded to :func:`solve`."""
    res = solve(
        Y, n_components, max_iter=max_iter, tol=tol, alpha=alpha, beta=beta,
        W_init=W_init, H_init=H_init, mask=mask, random_state=random_state,
        verbose=verbose, orientation=orientation, eps=eps, **kwargs,
    )
    return res.W, res.H, res.losses, res.time_elapsed, res.n_iter
