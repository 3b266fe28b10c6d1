"""The port's R data reader, NaN checks and kernel build cache
(``nbmf_mm_tpu_torch/utils/``: ``rdata.py``, ``debugging.py``, ``cache.py``)."""

import os

import numpy as np
import pytest
import torch

import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu_torch.ops import _build
from nbmf_mm_tpu_torch.utils import (
    cache,
    debugging,
    enable_compilation_cache,
    enable_nan_checks,
    load_r_matrix,
    maybe_enable_compilation_cache,
    nan_checks,
    read_rda,
)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
DATASETS = {"animals": (50, 85), "lastfm": (1226, 285), "paleo": (253, 902)}


def _binary(m=24, n=16, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < 0.4).astype(np.float64)


# --------------------------------------------------------------------- rdata
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_rda_matches_the_committed_npz(name):
    M, obj_name = load_r_matrix(os.path.join(DATA, f"{name}.rda"))
    assert obj_name == name and M.shape == DATASETS[name]
    np.testing.assert_array_equal(M, np.load(os.path.join(DATA, f"{name}.npz"))["Y"])
    assert set(np.unique(M)) <= {0.0, 1.0}


def test_read_rda_returns_the_named_objects():
    objects = read_rda(os.path.join(DATA, "animals.rda"))
    assert list(objects) == ["animals"]


@pytest.mark.parametrize("payload", [b"not an rda at all", b"RDX2\n" + b"\x00" * 3, b""])
def test_rda_reader_rejects_garbage(tmp_path, payload):
    p = tmp_path / "bad.rda"
    p.write_bytes(payload)
    with pytest.raises(ValueError):
        read_rda(p)


# ---------------------------------------------------------------- NaN checks
@pytest.fixture
def checks_off():
    """Every test starts with the flag off and leaves it as it found it."""
    saved = debugging.nan_checks_enabled()
    enable_nan_checks(False)
    yield
    enable_nan_checks(saved)


def test_enable_nan_checks_global_toggle(checks_off):
    enable_nan_checks(True)
    assert debugging.nan_checks_enabled()
    enable_nan_checks(False)
    assert not debugging.nan_checks_enabled()


def test_nan_checks_restores_the_flag(checks_off):
    with nan_checks():
        assert debugging.nan_checks_enabled()
    assert not debugging.nan_checks_enabled()
    enable_nan_checks(True)
    with nan_checks():
        pass
    assert debugging.nan_checks_enabled()
    enable_nan_checks(False)
    with pytest.raises(RuntimeError, match="body"):
        with nan_checks():
            raise RuntimeError("body")
    assert not debugging.nan_checks_enabled()


# A NaN prior parameter turns the first H update into NaN; the kernels never
# see alpha, so every loop reaches its check.
NAN_SOLVES = {
    "plain": dict(backend="plain", dtype="float64"),
    "fused": dict(backend="fused", dtype="float32"),
    "plain-restarts": dict(backend="plain", dtype="float64", n_init=3),
    "fused-restarts": dict(backend="fused", dtype="float32", n_init=3),
}


@pytest.mark.parametrize("case", sorted(NAN_SOLVES))
def test_nan_checks_raise_on_a_nan_solve(checks_off, case):
    kw = dict(NAN_SOLVES[case], max_iter=5, alpha=float("nan"), random_state=0, device="cpu")
    res = port.solve(_binary(), 3, **kw)  # off: the NaN goes through silently
    assert not np.isfinite(res.losses).all()
    loop = "plain loop" if case.startswith("plain") else "fused loop"
    with nan_checks():
        with pytest.raises(FloatingPointError, match=f"{loop}: .* after sweep 0"):
            port.solve(_binary(), 3, **kw)
    assert not debugging.nan_checks_enabled()


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_nan_checks_raise_in_the_fold_in(checks_off, backend):
    H = np.random.default_rng(1).uniform(0.1, 0.9, (3, 16))
    H[0, 0] = np.nan
    server = port.FoldInServer(H, n_iter=4, buckets=(32,), backend=backend, dtype="float32",
                               device="cpu")
    W, _ = server.transform(_binary())
    assert not np.isfinite(W).all()
    with nan_checks(), pytest.raises(FloatingPointError, match="fold-in loop: W .* sweep 0"):
        server.transform(_binary())


@pytest.mark.parametrize("case", sorted(NAN_SOLVES))
def test_nan_checks_leave_a_clean_solve_bitwise(checks_off, case):
    kw = dict(NAN_SOLVES[case], max_iter=12, tol=0.0, random_state=0, device="cpu")
    off = port.solve(_binary(), 3, **kw)
    with nan_checks():
        on = port.solve(_binary(), 3, **kw)
    assert on.n_iter == off.n_iter == 12 and on.losses == off.losses
    np.testing.assert_array_equal(on.W, off.W)
    np.testing.assert_array_equal(on.H, off.H)


def test_nan_checks_leave_serving_bitwise(checks_off):
    H = np.random.default_rng(2).uniform(0.1, 0.9, (3, 16))
    server = port.FoldInServer(H, n_iter=6, buckets=(32,), backend="fused", device="cpu")
    W_off, s_off = server.transform(_binary())
    with nan_checks():
        W_on, s_on = server.transform(_binary())
    np.testing.assert_array_equal(W_on, W_off)
    np.testing.assert_array_equal(s_on, s_off)


# --------------------------------------------------------- kernel build cache
@pytest.fixture
def build_dir(monkeypatch):
    """The build directory and NBMF_CACHE_DIR put back after the test, and
    any build attempted in it refused."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("NBMF_CACHE_DIR", raising=False)

    def no_build(*args, **kwargs):
        raise AssertionError("enable_compilation_cache must not build")

    monkeypatch.setattr(_build, "_compile", no_build)


def test_default_build_dir_is_in_the_checkout(build_dir):
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    assert str(_build.BUILD_DIR) == os.path.join(root, "build", "nbmf_mm_tpu_torch")


def test_enable_compilation_cache_takes_the_path(build_dir, tmp_path):
    target = tmp_path / "kernels"
    assert enable_compilation_cache(str(target)) == str(target)
    assert target.is_dir() and list(target.iterdir()) == []
    assert _build.BUILD_DIR == target
    assert _build._library_path().parent == target


def test_enable_compilation_cache_reads_the_environment(build_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("NBMF_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compilation_cache() == str(tmp_path / "env")
    assert _build.BUILD_DIR == tmp_path / "env"


def test_enable_compilation_cache_default_is_under_home(build_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    path = enable_compilation_cache()
    assert path == str(tmp_path / ".cache" / "nbmf_mm_tpu_torch" / "kernels")
    assert os.path.isdir(path) and os.listdir(path) == []


def test_maybe_enable_compilation_cache_needs_the_variable(build_dir, tmp_path, monkeypatch):
    before = _build.BUILD_DIR
    assert maybe_enable_compilation_cache() is None
    assert _build.BUILD_DIR == before
    monkeypatch.setenv("NBMF_CACHE_DIR", str(tmp_path / "c"))
    assert maybe_enable_compilation_cache() == str(tmp_path / "c")
    assert _build.BUILD_DIR == tmp_path / "c"
    assert cache.__all__ == ["enable_compilation_cache", "maybe_enable_compilation_cache"]
