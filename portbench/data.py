"""A cell's data, made on the device from ``--seed`` by the benchmark and
handed to the program and to the reference alike.

A configuration's ``data`` names a recipe of the probabilities ``P`` of its
entries:

- ``ground_truth``: a rank-``k_true`` Bernoulli ground truth ``P* = W* H*``,
  a frozen copy of ``GroundTruth`` in
  ``nbmf_mm_tpu_torch/experiments/flagship_scale.py`` (``W*`` rows on the
  simplex from U(0.05, 1), ``H*`` from U(0.05, 0.95), ``P*`` clipped to
  ``[clip, 1 - clip]``);
- ``bernoulli``: every entry at ``density``.

Binary data is drawn ``Y = (u < P)`` with ``u`` from a generator of its own
for every block of :data:`RNG_ROWS` rows, as ``GroundTruth.rows`` draws it,
so any chunking gives the same matrix.  Soft labels are ``P`` itself.

A training mask (a traffic's ``observed`` share) is drawn the same way,
``M = (v < observed)`` per entry, with ``v`` from a stream of its own: its
blocks' generator seeds lie :data:`MASK_STREAM` past the data's, so no seed
of one stream is a seed of the other while a matrix has fewer than
``MASK_STREAM`` blocks of rows.
"""

from __future__ import annotations

import contextlib

import torch

RNG_ROWS = 256
CHUNK_ENTRIES = 1 << 25  # entries of one transient row chunk
MASK_STREAM = 500_000  # the mask's block seeds, past the data's (seed * 1_000_003 + 1 + block)


class Recipe:
    """The probabilities and the binary draw of a configuration's data."""

    def __init__(self, config: dict, seed: int, device):
        self.m, self.n = int(config["m"]), int(config["n"])
        self.seed, self.device = int(seed), torch.device(device)
        spec = config["data"]
        self.kind = spec["kind"]
        if self.kind == "ground_truth":
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            k_true = int(spec["k_true"])
            W = 0.05 + 0.95 * torch.rand((self.m, k_true), generator=gen, device=self.device)
            self.W = W / W.sum(dim=1, keepdim=True)
            self.H = 0.05 + 0.9 * torch.rand((k_true, self.n), generator=gen, device=self.device)
            self.clip = float(spec["clip"])
        elif self.kind == "bernoulli":
            self.density = float(spec["density"])
        else:
            raise ValueError(f"unknown data recipe {self.kind!r}")
        self.gen = torch.Generator(device=self.device)

    def probabilities(self, a: int, b: int) -> torch.Tensor:
        """``P`` of rows ``[a, b)``, float32 on the device."""
        if self.kind == "bernoulli":
            return torch.full((b - a, self.n), self.density, device=self.device)
        return torch.clamp(self.W[a:b] @ self.H, self.clip, 1.0 - self.clip)

    def block_seed(self, block: int, stream: int = 0) -> int:
        """The generator seed of a block of :data:`RNG_ROWS` rows: the data's
        (``stream`` 0) or the mask's (:data:`MASK_STREAM`)."""
        return self.seed * 1_000_003 + 1 + stream + block

    def uniform_rows(self, a: int, b: int, stream: int = 0) -> torch.Tensor:
        """U(0, 1) draws of rows ``[a, b)`` from the blocks of ``stream``."""
        first, last = a // RNG_ROWS, -(-b // RNG_ROWS)
        u = []
        for block in range(first, last):
            self.gen.manual_seed(self.block_seed(block, stream))
            u.append(torch.rand((RNG_ROWS, self.n), generator=self.gen, device=self.device))
        return torch.cat(u)[a - first * RNG_ROWS: b - first * RNG_ROWS]

    def binary_rows(self, a: int, b: int) -> torch.Tensor:
        """The binary draw of rows ``[a, b)``, float32 0/1 on the device."""
        return (self.uniform_rows(a, b) < self.probabilities(a, b)).to(torch.float32)

    def mask_rows(self, a: int, b: int, observed: float) -> torch.Tensor:
        """The training mask of rows ``[a, b)``: each entry observed (1) with
        probability ``observed``, float32 0/1 on the device."""
        return (self.uniform_rows(a, b, MASK_STREAM) < observed).to(torch.float32)

    def chunk_rows(self) -> int:
        return max(RNG_ROWS, CHUNK_ENTRIES // self.n // RNG_ROWS * RNG_ROWS)

    def fill(self, rows, dtype) -> torch.Tensor:
        """The whole ``(m, n)`` matrix of ``rows(a, b)`` in ``dtype``, made
        chunk by chunk into one tensor."""
        out = torch.empty((self.m, self.n), dtype=dtype, device=self.device)
        step = self.chunk_rows()
        for a in range(0, self.m, step):
            b = min(a + step, self.m)
            out[a:b] = rows(a, b)
        return out

    def binary(self) -> torch.Tensor:
        """The binary matrix as uint8 (a byte an entry)."""
        return self.fill(self.binary_rows, torch.uint8)

    def mask(self, observed: float) -> torch.Tensor:
        """The training mask as uint8 (a byte an entry)."""
        return self.fill(lambda a, b: self.mask_rows(a, b, observed), torch.uint8)

    def soft(self) -> torch.Tensor:
        """The soft labels ``P`` as float32."""
        return self.fill(self.probabilities, torch.float32)


@contextlib.contextmanager
def ieee_fp32():
    """Products in IEEE float32 (no TF32) on the card, for the data and the
    reference; the previous settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
