"""The operation and byte counts, the peaks, and the per-layer readers on
records made by hand."""

import math

import pytest

from portbench import manifest, roofline


def test_peaks_are_the_data_sheet():
    assert roofline.PEAK == {"highest": 67e12, "high": 495e12, "default": 989e12}
    assert roofline.HBM_RATE == 3.35e12


def test_bound_takes_the_larger_side():
    assert roofline.bound(67e12, 0, 67e12) == (1.0, "operations")
    assert roofline.bound(0, 3.35e12, 67e12) == (1.0, "bytes")


def test_flagship_sweep_is_operation_bound():
    m, n, k = 100_000, 10_000, 128
    assert roofline.pass_flops(m, n, k, 1) == 6 * m * n * k
    for data in ("packed", "soft_dense", "dense_masked"):
        t = roofline.sweep_seconds(m, n, k, 1, "highest", data)
        assert t == pytest.approx(2 * 6 * m * n * k / 67e12)  # 22.93 ms
    lanes = roofline.sweep_seconds(10_000, 10_000, 128, 16, "highest", "packed")
    assert lanes == pytest.approx(16 * 2 * 6 * 1e8 * 128 / 67e12)


def test_data_bytes_by_input():
    assert roofline.DATA_BYTES == {"packed": 1 / 8, "soft_dense": 4, "dense_masked": 2 / 8}


def test_small_rank_dense_sweep_is_byte_bound():
    m, n, k = 100_000, 10_000, 1
    t = roofline.sweep_seconds(m, n, k, 1, "default", "soft_dense")
    assert t > 2 * 6 * m * n * k / 989e12
    assert t >= 2 * 4 * m * n / 3.35e12


RECORD = dict(window_s=10.0, busy_s=9.8, kernel_busy_s=9.7, launches=4600, syncs=102,
              fit_start_ms=[40.0, 60.0], fits=1, sweeps=100, m=100_000, n=10_000, k=128,
              lanes=1, precision="highest", input="packed",
              spans={"nbmf_mm.stage": {"count": 2, "host_s": 0.3, "idle_s": 0.2}})


def test_readers_on_a_record():
    read = lambda name, rec=RECORD: manifest.reader(name)(rec)
    least = 100 * 2 * 6 * 1e9 * 128 / 67e12
    assert read("kernel_roofline_pct.fit") == pytest.approx(100 * least / 9.7)
    assert read("sweep_mfu_pct.fit") == pytest.approx(100 * least / 10.0)
    assert read("device_idle_pct.fit") == pytest.approx(2.0)
    assert read("launches_per_sweep.fit") == 46.0
    assert read("host_syncs_per_sweep.fit") == 1.02
    assert read("fit_start_ms.fit") == 50.0
    assert read("staging_ms.fit") == pytest.approx(150.0)
    assert read("staging_ms.fit", dict(RECORD, spans={"nbmf_mm.loop": {}})) is None


@pytest.mark.parametrize("name", ["kernel_roofline_pct.fit", "sweep_mfu_pct.fit",
                                  "device_idle_pct.fit", "launches_per_sweep.fit",
                                  "host_syncs_per_sweep.fit", "fit_start_ms.fit",
                                  "staging_ms.fit"])
def test_readers_return_nothing_without_a_trace(name):
    assert manifest.reader(name)({}) is None


def test_roofline_shares_stay_under_100_when_kernels_take_the_least_time():
    rec = dict(RECORD, kernel_busy_s=2 * 6 * 1e9 * 128 / 67e12 * 100)
    assert manifest.reader("kernel_roofline_pct.fit")(rec) == pytest.approx(100.0)
    assert not math.isnan(manifest.reader("sweep_mfu_pct.fit")(rec))
