"""The port's experiment runners (``nbmf_mm_tpu_torch.experiments``) against
the repository's JAX runners (``experiments/``), on the CPU.

- The data layer: datasets, splits (the committed animals split and the
  seeded lastfm and paleo splits, bitwise), ``compute_perplexity`` and the
  readers of the original author's stored results, against
  ``experiments/data.py``.
- Figure 1 on animals, the 10-init NBMF-MM protocol and one Figure 3 rank,
  each with a small sweep budget, against the JAX runners' functions in
  float64 from the same inits (both packages' ``_random_uniform_inits``
  replaced by one numpy draw): perplexities and NLLs within 1e-8 relative,
  sweep counts equal.
- ``flagship_scale``'s chunked synthesis at 2048 x 600: the words equal
  ``pack_matrix`` of the dense draw whatever the chunking, and the oracle NLL
  the dense computation to 1e-12.
- ``validate_implementation`` exits 0; ``benchmark_suite`` and
  ``flagship_scale`` write their CSVs with the JAX runners' columns.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.data as jdata
import experiments.reproduce_magron2022 as jrep
import nbmf_mm_tpu_torch as port
from nbmf_mm_tpu.solver import driver as jd
from nbmf_mm_tpu_torch.experiments import benchmark_suite as bench
from nbmf_mm_tpu_torch.experiments import data as pdata
from nbmf_mm_tpu_torch.experiments import flagship_scale as flag
from nbmf_mm_tpu_torch.experiments import reproduce_magron2022 as prep
from nbmf_mm_tpu_torch.experiments import validate_implementation as valid
from nbmf_mm_tpu_torch.solver import driver as pd

torch.set_num_threads(1)

REL = 1e-8
F64 = "float64"


# ------------------------------------------------------------- data layer
@pytest.mark.parametrize("name", pdata.DATASETS)
def test_datasets_and_splits_are_the_jax_runners(name):
    Y = pdata.load_dataset(name)
    np.testing.assert_array_equal(Y, jdata.load_dataset(name))
    assert Y.dtype == np.float64
    ours, theirs = pdata.load_dataset_and_splits(name), jdata.load_dataset_and_splits(name)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    total = sum(ours[1:])
    np.testing.assert_array_equal(total, 1.0)


@pytest.mark.parametrize("shape", [(1226, 285), (253, 902), (40, 30)])
@pytest.mark.parametrize("seed", [12345, 1])
def test_entry_split_is_bitwise(shape, seed):
    ours, theirs = pdata.generate_entry_split(shape, seed), jdata.generate_entry_split(shape, seed)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        pdata.load_dataset("mnist")


def test_compute_perplexity_is_the_jax_runners():
    rng = np.random.default_rng(0)
    Y = (rng.random((30, 20)) < 0.4).astype(float)
    P = rng.uniform(0.01, 0.99, Y.shape)
    mask = (rng.random(Y.shape) < 0.7).astype(float)
    for m in (None, mask):
        assert pdata.compute_perplexity(Y, P, m) == jdata.compute_perplexity(Y, P, m)


@pytest.mark.parametrize("name", pdata.DATASETS)
def test_magron_readers_are_the_jax_runners(name):
    for method in ("NBMF-MM", "NBMF-EM", "logPCA"):
        assert pdata.magron_test_init(name, method) == jdata.magron_test_init(name, method)
    assert pdata.magron_test_init(name, "nope") is None
    for k in (2, 4, 8, 16, 3):
        assert pdata.magron_best_val_logpplx(name, k) == jdata.magron_best_val_logpplx(name, k)


def test_runner_constants_are_the_jax_runners():
    for name in ("SEED", "N_INIT", "ALPHA_GRID", "BETA_GRID", "FIG1_K", "FIG2_PARAMS",
                 "MAGRON_MM_PARAMS", "BASELINE_K", "FIG2_MAX_ITER", "FIG3_KS", "FIG3_PARAMS"):
        assert getattr(prep, name) == getattr(jrep, name), name


def test_outputs_go_under_chiprun_out():
    out = prep.default_outdir()
    assert out.parts[-2:] == ("chiprun_out", "experiments")
    assert "outputs" not in out.parts


# ------------------------------------------------------------- the figures
@pytest.fixture
def same_inits(monkeypatch):
    """Both packages draw their random inits from one numpy generator."""
    def draws(n_init, m, n, k):
        rng = np.random.default_rng(77)
        return (rng.uniform(0.1, 0.9, (n_init, m, k)), rng.uniform(0.1, 0.9, (n_init, k, n)))

    monkeypatch.setattr(jd, "_random_uniform_inits", lambda key, n_init, m, n, k, dtype: tuple(
        jnp.asarray(a, dtype=dtype) for a in draws(n_init, m, n, k)))
    monkeypatch.setattr(pd, "_random_uniform_inits", lambda seed, n_init, m, n, k, dtype: tuple(
        torch.tensor(a, dtype=dtype) for a in draws(n_init, m, n, k)))


def _capture_jax_rows(monkeypatch):
    rows = []
    monkeypatch.setattr(jrep, "_write_csv", lambda path, r: rows.append((path.name, r)))
    return rows


def _close_rows(ours, theirs, floats, ints):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for key in floats:
            assert a[key] == pytest.approx(b[key], rel=REL), key
        for key in ints:
            assert a[key] == b[key], key


@pytest.mark.usefixtures("same_inits")
def test_figure1_on_animals_matches_the_jax_runner(monkeypatch, tmp_path):
    def short(grid):
        return lambda *a, **kw: grid(*a, **dict(kw, max_iter=25))

    monkeypatch.setattr(jrep, "grid_solve", short(jrep.grid_solve))
    monkeypatch.setattr(port, "grid_solve", short(port.grid_solve))
    captured = _capture_jax_rows(monkeypatch)
    jrep.run_figure1(["animals"], tmp_path, F64)
    ours = prep.figure1_rows("animals", F64, "cpu")
    assert captured[0][0] == "figure1_animals_results.csv" and len(ours) == 36
    _close_rows(ours, captured[0][1], ("alpha", "beta", "train_perplexity", "val_perplexity"),
                ("n_iter",))
    assert list(ours[0]) == list(captured[0][1][0])


@pytest.mark.usefixtures("same_inits")
@pytest.mark.parametrize("ds", ["animals", "paleo"])
def test_ten_init_protocol_matches_the_jax_runner(monkeypatch, ds):
    monkeypatch.setattr(jrep, "FIG2_MAX_ITER", {ds: 30})
    monkeypatch.setattr(prep, "FIG2_MAX_ITER", {ds: 30})
    Y, train, _, test = pdata.load_dataset_and_splits(ds)
    theirs = jrep._mm_10init_protocol(Y, train, test, ds, F64)
    ours, nlls = prep.mm_10init_protocol(Y, train, test, ds, F64, "cpu")
    assert ours.keys() == theirs.keys() and len(nlls) == prep.N_INIT
    for key in ("mm10_test_nll_mean", "mm10_test_nll_std", "magron_mm_test_nll_mean",
                "magron_mm_test_nll_std"):
        assert ours[key] == pytest.approx(theirs[key], rel=REL), key
    assert ours["mm10_iters_mean"] == theirs["mm10_iters_mean"]


@pytest.mark.usefixtures("same_inits")
def test_figure3_rank_matches_the_jax_runner(monkeypatch, tmp_path):
    monkeypatch.setattr(jrep, "FIG3_KS", [4])
    monkeypatch.setattr(prep, "FIG3_KS", [4])
    captured = _capture_jax_rows(monkeypatch)
    jrep.run_figure3(["animals"], tmp_path, F64)
    ours = prep.figure3_rows("animals", F64, "cpu")
    _close_rows(ours, captured[0][1], ("alpha", "beta", "test_perplexity"), ("k", "n_iter"))
    assert list(ours[0]) == list(captured[0][1][0])


def test_figure2_row_has_the_jax_columns(monkeypatch):
    monkeypatch.setattr(prep, "FIG2_MAX_ITER", {"animals": 20})
    row, model, nlls = prep.figure2_row("animals", F64, "cpu", with_baselines=False)
    assert list(row) == ["dataset", "k", "alpha", "beta", "test_perplexity",
                         "magron_best_val_perplexity", "n_iter", "converged", "time",
                         "mm10_test_nll_mean", "mm10_test_nll_std", "mm10_iters_mean",
                         "mm10_batch_time", "magron_mm_test_nll_mean", "magron_mm_test_nll_std"]
    assert model.n_iter_ == row["n_iter"] <= 20 and np.isfinite(nlls).all()


def test_main_writes_the_figure_csvs(monkeypatch, tmp_path):
    monkeypatch.setattr(prep, "FIG3_KS", [2])
    monkeypatch.setattr(prep, "FIG2_MAX_ITER", {"animals": 10})
    assert prep.main(["--datasets", "animals", "--figures", "2", "3", "--device", "cpu",
                      "--outdir", str(tmp_path), "--no-baselines"]) == 0
    names = {p.name for p in tmp_path.iterdir()}
    assert {"figure2_results.csv", "figure3_animals_results.csv",
            "figure2_animals_model.npz"} <= names


# ------------------------------------------------------------- flagship
@pytest.mark.parametrize("chunk_entries", [600 * 256, 600 * 700, 600 * 4096])
def test_chunked_synthesis_is_the_dense_draw(chunk_entries, monkeypatch):
    monkeypatch.setattr(flag, "CHUNK_ENTRIES", chunk_entries)
    pm, nll = flag.synth_packed(0, 2048, 600, 16, 8, "cpu")
    truth = flag.GroundTruth(0, 2048, 600, 16, "cpu")
    Y, _ = truth.rows(0, 2048)
    assert set(np.unique(Y.numpy())) <= {0.0, 1.0}
    dense = port.pack_matrix(Y.numpy(), 8, device="cpu")
    assert torch.equal(pm.words, dense.words) and pm.shape == (2048, 600)
    P = np.clip((truth.W @ truth.H).numpy(), 1e-6, 1 - 1e-6).astype(np.float64)
    y = Y.numpy().astype(np.float64)
    oracle = -np.sum(y * np.log(P) + (1 - y) * np.log1p(-P)) / y.size
    assert nll == pytest.approx(oracle, rel=1e-12)


def test_ground_truth_rows_do_not_depend_on_the_chunking():
    truth = flag.GroundTruth(3, 700, 50, 4, "cpu")
    whole, _ = truth.rows(0, 700)
    parts = torch.cat([truth.rows(a, min(a + 300, 700))[0] for a in range(0, 700, 300)])
    assert torch.equal(whole, parts)


def test_flagship_rows_have_the_jax_columns(monkeypatch, tmp_path):
    monkeypatch.setattr(flag, "CONFIGS", [("tiny", 512, 200, 4, 3, 40)])
    monkeypatch.setattr(flag, "SPARSE", [("tiny_sparse", 512, 200, 4, 0.05, 40)])
    assert flag.main(["--device", "cpu", "--outdir", str(tmp_path)]) == 0
    with open(tmp_path / "flagship_scale_cpu.csv") as f:
        rows = list(csv.DictReader(f))
    with open("outputs/flagship_scale_tpu.csv") as f:
        assert tuple(csv.DictReader(f).fieldnames) == flag.FIELDS
    assert [r["config"] for r in rows] == ["tiny", "tiny_sparse"]
    for r in rows:
        assert r["converged"] in ("True", "False") and int(r["n_iter"]) <= 40
        assert float(r["worst_descent_violation"]) <= 5e-4 * float(r["final_loss"])


# ------------------------------------------------------ validate, bench
def test_validate_implementation_exits_zero():
    assert valid.main(["--device", "cpu"]) == 0


def test_benchmark_suite_rows_have_the_jax_columns():
    rows = bench.quickstart_row(None, "cpu") + bench.throughput_row(64, 4, 2, "cpu")
    assert list(rows[0]) == ["config", "test_perplexity", "train_perplexity", "n_iter",
                             "fit_time_cold_s", "fit_time_warm_s", "sweeps_per_sec"]
    assert rows[1]["n_iter"] == 6 and list(rows[1]) == list(rows[0])


def test_throughput_sweeps_are_clamped(monkeypatch):
    assert bench.MAX_TIMED_SWEEPS == 3000
    monkeypatch.setattr(bench, "MAX_TIMED_SWEEPS", 30)
    _, hi = bench.loop_slope_ms(32, 2, 10**9, "cpu", reps=1)
    assert hi == 30
