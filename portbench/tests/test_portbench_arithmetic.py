"""The metric arithmetic: rate over the window, p95 over every request, the
device's idle share, rooflines and the kernels' costs; the readers on
records of known numbers; the checks against limits."""

from __future__ import annotations

import math
import os

import pytest

from portbench.costs import kernels
from portbench.harness import checks, stats
from portbench.harness.catalog import Catalog


def test_rate_is_all_work_over_all_the_window():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentile_is_nearest_rank_over_every_value():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(1, 21)), 95) == 19  # 19 of 20 at or below


def test_busy_is_the_union_of_intervals():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.merged(intervals) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.busy(intervals) == 3.0
    assert stats.idle_pct(3.0, 4.0) == 25.0


def test_roofline_and_rel_rmse():
    assert stats.roofline_pct(1.0, 4.0) == 25.0
    assert stats.rel_rmse([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert math.isclose(stats.rel_rmse([1.1, 0.0], [1.0, 0.0]), 0.1 / math.sqrt(1.0))


def test_least_time_takes_the_larger_bound():
    peaks = kernels.PEAKS
    assert kernels.least_s(peaks["hbm_bytes_per_s"], 0, 1) == 1.0
    assert kernels.least_s(0, 2e12, 1e12) == 2.0
    assert kernels.ceil_out(112) == 56 and kernels.ceil_out(105) == 52
    # a pool's pair moves more than its forward and never less than its input
    assert kernels.max_pool(10, 64, 112, 112, 2, True) > kernels.max_pool(10, 64, 112, 112, 2,
                                                                             False)


@pytest.fixture(scope="module")
def readers():
    """Every reader the benchmark holds, listed in BENCHMARK.json or not."""
    catalog = Catalog()
    folder = os.path.join(catalog.bench, "metrics")
    return {f[:-3]: catalog.reader(f[:-3]) for f in os.listdir(folder) if f.endswith(".py")}


def test_serving_readers(readers):
    record = {"clips": 300, "window_s": 30.0, "latencies_s": [0.1] * 95 + [0.5] * 5,
              "peak_bytes": 2 * 2**30, "setup_s": 12.5, "chips": 1, "flops_per_clip": 4e11,
              "items_traced": 4,
              "spans": {"towers_ms": 400.0, "requests": 5},
              "work_least_s": {"mha": 0.001, "pe_block": 0.5},
              "trace": {"wall_s": 2.0, "busy_s": 1.5, "device_events": 10, "htod_s": 0.2,
                        "per_name_s": {"void attend_kernel<4>": 0.016, "Memcpy HtoD": 0.2}}}
    assert readers["serve_clips_per_s"].read(record) == 10.0
    assert readers["serve_latency_p95_ms"].read(record) == 100.0
    assert readers["peak_mem_gib"].read(record) == 2.0
    assert readers["setup_s"].read(record) == 12.5
    assert readers["h2d_copy_ms.serve"].read(record) == 50.0
    assert readers["towers_ms.serve"].read(record) == 80.0
    assert readers["device_idle_pct.serve"].read(record) == 25.0
    # pe_block never launched: its work and time are left out
    assert readers["kernels_roofline.serve"].read(record) == pytest.approx(25.0)
    assert readers["mfu.serve"].read(record) == pytest.approx(
        100 * 4e11 * 300 / (30 * kernels.PEAKS["bf16_flops_per_s"]))
    untraced = {k: v for k, v in record.items() if k not in ("trace", "spans", "work_least_s",
                                                            "flops_per_clip")}
    for name in ("h2d_copy_ms.serve", "towers_ms.serve", "kernels_roofline.serve", "mfu.serve",
                 "device_idle_pct.serve"):
        assert readers[name].read(untraced) is None


def test_training_readers(readers):
    record = {"clips": 480, "window_s": 10.0, "chips": 1, "step_host_s": [0.2, 0.4],
              "trace": {"wall_s": 1.0, "busy_s": 0.4, "device_events": 3, "htod_s": 0.0,
                        "per_name_s": {}}}
    assert readers["train_clips_per_s"].read(record) == 48.0
    assert readers["step_host_ms.train"].read(record) == pytest.approx(300.0)
    assert readers["device_idle_pct.train"].read(record) == pytest.approx(60.0)
    assert readers["kernels_roofline.train"].read(record) is None


def test_serve_numbers_take_the_worst_request():
    want = {0: {"verb": [[1.0, 2.0]], "noun": [[3.0]]}, 1: {"verb": [[1.0, 1.0]], "noun": [[1.0]]}}
    completed = [(0, {"verb": [[1.0, 2.0]], "noun": [[3.0]]}),
                 (1, {"verb": [[1.0, 1.0]], "noun": [[1.3]]})]
    numbers = checks.serve_numbers(completed, want, ["verb", "noun"])
    assert numbers["logits_rel_rmse"] == pytest.approx(stats.rel_rmse([1, 1, 1.3], [1, 1, 1]))
    correct, judged = checks.judge(numbers, {"logits_rel_rmse": {"limit": 0.1}})
    assert not correct and judged["logits_rel_rmse"]["limit"] == 0.1
    assert not checks.judge({}, {"logits_rel_rmse": {"limit": 0.1}})[0]  # missing fails


def test_train_numbers_leave_out_negligible_leaves():
    ref = {"losses": [2.0, 1.0], "logits": [{"v": [[1.0, 0.0], [0.0, 1.0]]}] * 2,
           "grad_norms": {"a": 1.0, "b": 2.0, "bias": 1e-9},
           "head_grads": {"fusion.w": [[1.0, 2.0]], "classifier.v.weight": [[2.0, 0.0]],
                          "classifier.v.bias": [1.0, -1.0]},
           "change_norms": {"a": 0.1, "b": 0.2, "bias": 1e-11, "bn.running_var": 0.05,
                            "bn.running_mean": 0.01}}
    port = {"losses": [2.02, 1.0], "logits": [{"v": [[1.0, 0.0], [0.0, 1.0]]},
                                              {"v": [[1.0, 0.0]]}],  # a row left out
            "grad_norms": {"a": 1.1, "b": 2.0, "bias": 0.0},
            "head_grads": {"classifier.v.weight": [[2.0, 0.0]],  # Fusion's left out
                           "classifier.v.bias": [0.5, -1.0]},
            "change_norms": {"a": 0.1, "b": 0.0, "bias": 0.0, "bn.running_var": 0.05,
                             "bn.running_mean": 0.0}}
    numbers, leaves = checks.train_numbers(port, ref)
    assert numbers["loss_rel_gap"] == pytest.approx(0.01) == numbers["loss_rel_gap_first"]
    assert numbers["logits_rel_rmse"] == pytest.approx(stats.rel_rmse([1, 0, 0, 0], [1, 0, 0, 1]))
    assert numbers["logits_rel_rmse_first"] == 0.0 and numbers["clips_missing"] == 1.0
    # the median kept leaf (1.5) is the floor: a reads 0.1 / 1.5, b 0
    assert numbers["grad_norm_gap_worst"] == pytest.approx(0.1 / 1.5)
    assert numbers["grad_norm_gap_median"] == pytest.approx(0.05 / 1.5)
    # b left unmoved reads 1; the statistics apart: the mean unmoved reads
    # its change over the median statistic's (0.03)
    assert numbers["change_norm_gap_worst"] == pytest.approx(1.0)
    assert numbers["stats_change_gap_worst"] == pytest.approx(0.01 / 0.03)
    assert leaves["stats_change_gap"][0][1] == "bn.running_mean"
    # the whole gradients, leaves laid end to end in name order
    assert numbers["classifier_bias_grad_rel_rmse"] == pytest.approx(
        stats.rel_rmse([0.5, -1.0], [1.0, -1.0]))
    assert numbers["classifier_grad_rel_rmse"] == pytest.approx(
        stats.rel_rmse([0.5, -1.0, 2.0, 0.0], [1.0, -1.0, 2.0, 0.0]))
    assert numbers["head_grad_rel_rmse"] == pytest.approx(
        stats.rel_rmse([0.5, -1.0, 2.0, 0.0, 0.0, 0.0], [1.0, -1.0, 2.0, 0.0, 1.0, 2.0]))
