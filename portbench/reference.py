"""The plain reference of a timed fit: the MM algorithm of Magron & Févotte
(2022) for ``V ~ Bernoulli(W H)``, written out in plain PyTorch over blocks of
rows, in IEEE float32 with the losses summed in float64.

It imports torch and numpy alone: nothing of the program and nothing of
JAX.  It works everything out again from what the benchmark made: the data
rows, and the inits from a frozen copy of the solver's draw (a CPU generator
seeded with the fit's ``random_state``: every ``W0 (n_init, m, k)`` draw,
then every ``H0 (n_init, k, n)`` draw, each U(0.1, 0.9) in float32).

Its losses follow the program's convention: entry ``t`` is the objective
after sweep ``t``, ``-(ll + (alpha-1) sum log(H+eps) + (beta-1) sum
log(1-H+eps)) / (m n)`` with ``ll = sum(y log(WH+eps) + (1-y) log(1-WH+eps))``.

With a training mask (``mask_mode`` ``"corrected"`` or ``"parity"``) the
rows are ``(y, mask)`` pairs and the masked MM of the paper runs on
``Ym = y mask`` and ``Ym2 = (1 - y) mask``, formed a block at a time: the H
update's denominator and ``ll`` read ``Yc``, which is ``Ym2`` in corrected
mode and ``1 - Ym`` in parity mode (the paper's reference code, which counts
unobserved entries as zeros there); the W step reads ``Ym2`` in both modes;
the objective is divided by ``n_obs``, the mask's count of observed entries,
counted exactly.  The W step divides by ``n`` before each row of ``W`` is
put back on the simplex, as the program does; the normalisation makes the
divisor immaterial.  Without a mask every operation runs in the order it
always has.
"""

from __future__ import annotations

import torch

BLOCK_ENTRIES = 1 << 26  # lanes x rows x columns of one block's temporaries


def initial_factors(seed: int, n_init: int, m: int, n: int, k: int):
    """``(W0 (n_init, m, k), H0 (n_init, k, n))`` on the CPU, in the
    solver's draw order."""
    gen = torch.Generator().manual_seed(int(seed))
    W0 = torch.rand((n_init, m, k), generator=gen, dtype=torch.float32) * 0.8 + 0.1
    H0 = torch.rand((n_init, k, n), generator=gen, dtype=torch.float32) * 0.8 + 0.1
    return W0, H0


def _upper(eps: float) -> float:
    """The largest H the update may give: ``1 - eps`` or, where that rounds to
    1 in float32, the float32 number just below 1."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(torch.minimum(one - eps, torch.nextafter(one, torch.tensor(0.0))))


class Fit:
    """``sweeps`` MM sweeps of ``lanes`` inits over the data ``rows(a, b)``
    (float32 rows of an ``(m, n)`` matrix on ``device``, or, with a
    ``mask_mode``, ``(y, mask)`` pairs of such rows)."""

    def __init__(self, rows, m: int, n: int, *, alpha: float, beta: float, eps: float,
                 device, mask_mode=None):
        if mask_mode not in (None, "corrected", "parity"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        self.rows, self.m, self.n, self.mask_mode = rows, m, n, mask_mode
        self.am1, self.bm1, self.eps = alpha - 1.0, beta - 1.0, eps
        self.device = torch.device(device)

    def _blocks(self, lanes: int, step_pass: str):
        """``(a, b, pos, neg)`` of each block of rows: the planes that the
        ratios' numerators take, ``Ym`` and the second plane of the H pass
        (``step_pass`` ``"h"``, its ``Yc``) or of the W step (``"w"``,
        ``Ym2``); without a mask ``y`` and ``1 - y``."""
        step = max(1, BLOCK_ENTRIES // (lanes * self.n))
        for a in range(0, self.m, step):
            b = min(a + step, self.m)
            if self.mask_mode is None:
                y = self.rows(a, b)
                yield a, b, y, 1.0 - y
                continue
            y, mask = self.rows(a, b)
            Ym = y * mask
            if step_pass == "h" and self.mask_mode == "parity":
                yield a, b, Ym, 1.0 - Ym
            else:
                yield a, b, Ym, (1.0 - y) * mask

    def n_obs(self):
        """The entries the objective is divided by: ``m n``, or the mask's
        count of observed entries."""
        if self.mask_mode is None:
            return self.m * self.n
        step = max(1, BLOCK_ENTRIES // self.n)
        return sum(int(torch.count_nonzero(self.rows(a, min(a + step, self.m))[1]))
                   for a in range(0, self.m, step))

    def _ratios(self, Wb, H, pos, neg, with_ll: bool):
        """``pos / (WH + eps)`` and ``neg / (max(1 - WH, 0) + eps)`` of a
        block, and, ``with_ll``, the block's log-likelihood per lane."""
        WH = Wb.transpose(1, 2) @ H
        lo, hi = WH + self.eps, torch.clamp_min(1.0 - WH, 0.0) + self.eps
        ll = None
        if with_ll:
            ll = (pos * torch.log(lo) + neg * torch.log(hi)).sum(dim=(1, 2),
                                                               dtype=torch.float64)
        return pos / lo, neg / hi, ll

    def h_terms(self, W, H):
        """``(W P, W Q, ll)`` over all rows: the H update's sums."""
        lanes, k = W.shape[:2]
        num = torch.zeros((lanes, k, self.n), dtype=torch.float32, device=self.device)
        den, ll = torch.zeros_like(num), torch.zeros(lanes, dtype=torch.float64,
                                                     device=self.device)
        for a, b, pos, neg in self._blocks(lanes, "h"):
            Wb = W[:, :, a:b]
            P, Q, block_ll = self._ratios(Wb, H, pos, neg, True)
            num += Wb @ P
            den += Wb @ Q
            ll += block_ll
        return num, den, ll

    def w_step(self, W, H):
        """The simplex factor after its MM step under the new ``H``:
        ``W (H P^T + (1 - H) Q^T) / n``, each column put back on the
        simplex."""
        out = torch.empty_like(W)
        for a, b, pos, neg in self._blocks(W.shape[0], "w"):
            Wb = W[:, :, a:b]
            P, Q, _ = self._ratios(Wb, H, pos, neg, False)
            T = H @ P.transpose(1, 2) + (1.0 - H) @ Q.transpose(1, 2)
            Wn = Wb * T / self.n
            sums = Wn.sum(dim=1, keepdim=True)
            out[:, :, a:b] = Wn / torch.where(sums > 0, sums, 1.0)
        return out

    def objective(self, ll, H, n_obs):
        Hd = H.double()
        prior = (self.am1 * torch.log(Hd + self.eps).sum(dim=(1, 2))
                 + self.bm1 * torch.log(1.0 - Hd + self.eps).sum(dim=(1, 2)))
        return -(ll + prior) / n_obs

    def run(self, W0, H0, sweeps: int):
        """``(W (lanes, m, k), H (lanes, k, n), losses (lanes, sweeps))`` from
        the external inits ``W0 (lanes, m, k)``, ``H0 (lanes, k, n)``; ``W``
        comes back with its rows put back on the simplex in float64, as the
        solver's final safeguard does."""
        W = W0.to(self.device).transpose(1, 2)
        W = (W / W.sum(dim=1, keepdim=True)).contiguous()  # (lanes, k, m), unit columns
        H = H0.to(self.device).contiguous()
        upper, n_obs = _upper(self.eps), self.n_obs()
        losses = torch.zeros((W.shape[0], sweeps), dtype=torch.float64, device=self.device)
        for t in range(sweeps + 1):
            num, den, ll = self.h_terms(W, H)
            if t >= 1:
                losses[:, t - 1] = self.objective(ll, H, n_obs)
            if t == sweeps:
                break
            a = H * num + self.am1
            b = (1.0 - H) * den + self.bm1
            H = torch.clamp(a / (a + b + self.eps), self.eps, upper)
            W = self.w_step(W, H)
        Wd = W.transpose(1, 2).double()
        return Wd / Wd.sum(dim=2, keepdim=True), H, losses
