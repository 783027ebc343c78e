"""The benchmark's formulas, readers, discovery and guards, on the CPU."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench_tiny import ROOT, SEED, tiny

from perfbench import (check, guard, reference, roofline, tracing, traffic,
                       work)
from perfbench.spec import Cell

CELLS = ["ec_solvent.fft_blocks", "dhfr_jac.fft_full",
         "ec_solvent.windowed_lag8k"]


# --- work and least time, against hand counts ------------------------------

def test_lag_pairs_and_work_by_hand():
    assert work.lag_pairs(5, 3) == 5 + 4 + 3
    assert work.lag_pairs(4, 4) == 4 + 3 + 2 + 1
    # the FFT path's L = N: P·N(N + 1)/2
    assert work.atom_frame_lags(8192, 3680, 8192) == 3680 * 8192 * 8193 // 2
    assert work.atom_frame_lags(6, 2, 2) == 2 * (6 + 5)


@pytest.mark.parametrize("case, nbytes, flop, peak", [
    # VACF by FFT, N = 4, P = 2, d = 3: a float32 feed of 4·2·3 values,
    # a float64 (4, 2) result; 2.5·8·log2(8) flop for each of 6 + 2
    # transforms of length 2N = 8
    (("vacf", True, 4, 2, 3, 4, 8), 4 * 24 + 8 * 8, 2.5 * 8 * 3 * 8,
     work.PEAK_MMA),
    # Helfand by FFT feeds two arrays
    (("helfand", True, 4, 2, 3, 4, 8), 2 * 4 * 24 + 8 * 8,
     2.5 * 8 * 3 * 8, work.PEAK_MMA),
    # windowed VACF, N = 5, L = 3: 12 frame pairs, 2 flop a component
    (("vacf", False, 5, 2, 3, 3, 8), 4 * 30 + 8 * 6, 2 * 3 * 2 * 12,
     work.PEAK_MMA),
    # windowed Helfand: 3 flop a component a pair, FP64 off the MMA
    (("helfand", False, 5, 2, 3, 3, 8), 2 * 4 * 30 + 8 * 6,
     3 * 3 * 2 * 12, work.PEAK_FP64),
    # float32 work: a float32 result, the FP32 peak
    (("helfand", False, 5, 2, 3, 3, 4), 2 * 4 * 30 + 4 * 6,
     3 * 3 * 2 * 12, work.PEAK_FP32),
])
def test_least_times_by_hand(case, nbytes, flop, peak):
    t_bytes, t_flop = work.least_times(*case)
    assert t_bytes == pytest.approx(nbytes / work.PEAK_BYTES, rel=1e-12)
    assert t_flop == pytest.approx(flop / peak, rel=1e-12)
    assert work.least_time(*case) == max(t_bytes, t_flop)


def test_least_time_of_the_cells_pair():
    """The EC block pair: bytes bind, 0.47 ms reckoned."""
    pair = sum(work.least_time(k, True, 8192, 3680, 3, 8192)
               for k in ("vacf", "helfand"))
    assert pair == pytest.approx((3 * 4 * 8192 * 11040 + 2 * 8 * 8192
                                  * 3680) / 3.35e12, rel=1e-12)
    assert 0.46e-3 < pair < 0.48e-3


# --- the trace record and the per-layer readers ----------------------------

def synthetic_events():
    """Chrome-trace events of a 1-second window holding two requests."""
    ms = 1000.0   # µs

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}

    return [
        x("user_annotation", "bench.window", 0, 1000 * ms),
        x("user_annotation", "request.0", 0, 400 * ms),
        x("user_annotation", "vacf.run", 0, 390 * ms),
        x("user_annotation", "request.1", 500 * ms, 500 * ms),
        x("user_annotation", "helfand.run", 500 * ms, 500 * ms),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10 * ms,
          100 * ms, bytes=500_000_000),
        x("kernel", "fft_level_columns_kernel", 120 * ms, 50 * ms),
        x("gpu_memset", "Memset (Device)", 170 * ms, 10 * ms),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 200 * ms,
          100 * ms, bytes=200_000_000),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 550 * ms,
          150 * ms, bytes=1_000_000_000),
        x("kernel", "einstein_tile_kernel", 700 * ms, 150 * ms),
        # outside the window: left out
        x("kernel", "late_kernel", 2000 * ms, 10 * ms),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]


def synthetic_record(fft=(True, False)):
    record = tracing.build_record(synthetic_events())
    record["requests"] = [
        {"index": 0, "kind": "vacf", "fft": fft[0], "least_s": 0.01,
         "io_s": 0.02, "wall_s": 0.4},
        {"index": 1, "kind": "helfand", "fft": fft[1], "least_s": 0.06,
         "io_s": 0.03, "wall_s": 0.5}]
    return record


def test_build_record_and_breakdown():
    record = synthetic_record()
    assert record["window_s"] == pytest.approx(1.0)
    assert [d["name"] for d in record["device"]][-1] == \
        "einstein_tile_kernel"
    assert [d["request"] for d in record["device"]] == [0, 0, 0, 0, 1, 1]
    assert [d["kind"] for d in record["device"]] == \
        ["HtoD", None, None, "DtoH", "HtoD", None]
    # busy: 10-110, 120-180, 200-300, 550-850 ms
    assert tracing.busy_s(record) == pytest.approx(0.1 + 0.06 + 0.1 + 0.3)
    b = tracing.breakdown(record)
    assert b["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)",
                                  pytest.approx(0.25)]
    # the longest gap, 300-550 ms, lies between the requests
    assert b["idle_gaps"][0][0] == "harness"
    assert b["idle_gaps"][0][1] == pytest.approx(0.25)
    assert b["idle_gaps"][1] == ["helfand.run", pytest.approx(0.15)]
    assert len(b["device_ops"]) <= tracing.TOP
    assert len(b["idle_gaps"]) <= tracing.TOP


def readers():
    return Cell("ec_solvent.fft_blocks").readers() | \
        Cell("ec_solvent.windowed_lag8k").readers()


def test_readers_by_hand():
    read = readers()
    record = synthetic_record()
    assert read["feed_io_pct"](record) == pytest.approx(5.0)
    assert read["h2d_gbps"](record) == pytest.approx(1.5e9 / 0.25 / 1e9)
    assert read["d2h_gbps"](record) == pytest.approx(2.0)
    # request 0 (FFT): 50 ms of kernels, the memset left out
    assert read["fft_roofline_pct"](record) == pytest.approx(20.0)
    # request 1 (windowed): 150 ms of kernels for 60 ms least
    assert read["lag_roofline_pct"](record) == pytest.approx(40.0)
    assert read["device_idle_pct"](record) == pytest.approx(44.0)
    # statistics.quantiles' default method puts the 95th percentile of
    # two walls at position 3 · 0.95 = 2.85, past the second
    assert read["solve_p95_s.blocks"](record) == pytest.approx(
        0.4 + 1.85 * 0.1)


def test_readers_find_nothing_to_read():
    read = readers()
    record = synthetic_record(fft=(True, True))
    assert read["lag_roofline_pct"](record) is None
    record["device"] = [d for d in record["device"] if d["kind"] != "DtoH"]
    assert read["d2h_gbps"](record) is None
    record["device"] = []
    for name in ("h2d_gbps", "fft_roofline_pct", "device_idle_pct"):
        assert read[name](record) is None
    assert roofline.share({"requests": [], "device": []}, True) is None


# --- the traffic -------------------------------------------------------------

def test_requests_same_work_for_every_seed():
    cell = tiny("ec_solvent.fft_blocks")
    n = cell.config["n_frames"]
    spans = traffic.blocks(cell.traffic, n)
    assert spans == [(0, 96), (96, 192), (192, 288), (288, 384)]

    def first(seed, k):
        stream = traffic.requests(cell.traffic, n, seed)
        return [next(stream) for _ in range(k)]

    a, b = first(1, 16), first(2 ** 31 + 7, 16)
    assert sorted(a) == sorted(b)
    assert a == first(1, 16)
    assert a != b
    # each block takes a VACF, then a Helfand
    kinds = [cell.traffic["analyses"][ai]["kind"] for ai, _, _ in a[:4]]
    assert kinds == ["vacf", "helfand"] * 2
    assert a[0][1:] == a[1][1:]


def test_generator_is_seeded_and_sized():
    cell = tiny("dhfr_jac.fft_full")
    one = cell.generator.generate(cell.config, SEED, "cpu")
    two = cell.generator.generate(cell.config, SEED, "cpu")
    other = cell.generator.generate(cell.config, SEED + 1, "cpu")
    n_atoms = sum(s["count"] * len(s["atoms"])
                  for s in cell.config["species"])
    assert one["velocities"].shape == (384, n_atoms, 3)
    assert one["velocities"].dtype.name == "float32"
    assert one["positions"].flags.c_contiguous
    assert (one["velocities"] == two["velocities"]).all()
    assert (one["positions"] == two["positions"]).all()
    assert not (one["velocities"] == other["velocities"]).all()


def test_request_shape_by_hand():
    # the FFT path takes every lag; a cut stops at the block's length
    assert work.request_shape(None, 8192, 16384) == (8192, 8192)
    assert work.request_shape(8192, 0, 65536) == (65536, 8192)
    assert work.request_shape(64, 0, 48) == (48, 48)


@pytest.mark.parametrize("dims, volume", [
    ([10.0, 10.0, 10.0, 90.0, 90.0, 90.0], 1000.0),
    # the EC cell: a rhombic dodecahedron, a³/√2
    ([41.432, 41.432, 41.432, 60.0, 60.0, 90.0], 41.432 ** 3 / 2 ** 0.5),
    ([2.0, 3.0, 4.0, 90.0, 90.0, 60.0], 24.0 * 3 ** 0.5 / 2),
])
def test_box_volume_by_hand(dims, volume):
    assert reference.box_volume(dims) == pytest.approx(volume, rel=1e-14)


def test_lattice_fills_the_triclinic_cell():
    """The EC cell's box vectors have its edges and angles, their triple
    product is the reference's volume, and every first-frame site lies
    inside the cell (fractional coordinates in [0, 1))."""
    import numpy as np
    import torch

    cell = tiny("ec_solvent.fft_blocks")
    gen_mod = cell.generator
    dims = gen_mod.dimensions(cell.config)
    assert dims == [41.432, 41.432, 41.432, 60.0, 60.0, 90.0]
    vecs = gen_mod.box_vectors(dims)
    assert np.linalg.norm(vecs, axis=1) == pytest.approx([41.432] * 3)
    cos = lambda i, j: vecs[i] @ vecs[j] / 41.432 ** 2  # noqa: E731
    assert [cos(1, 2), cos(0, 2), cos(0, 1)] == pytest.approx(
        [0.5, 0.5, 0.0], abs=1e-12)
    assert abs(np.linalg.det(vecs)) == pytest.approx(
        reference.box_volume(dims), rel=1e-12)
    gen = torch.Generator().manual_seed(SEED)
    first = gen_mod.lattice_positions(cell.config, gen, "cpu").double()
    frac = first.numpy() @ np.linalg.inv(vecs)
    assert frac.min() > -0.1 and frac.max() < 1.1
    system = gen_mod.generate(cell.config, SEED, "cpu")
    assert system["dimensions"] == dims


def test_shared_buffers_finds_a_reused_answer():
    import numpy as np

    a, b = np.zeros(8), np.ones(8)
    big = np.zeros((4, 3))
    held = [(0, [a], []), (1, [b], []), (2, [b[2:5]], []),
            (3, [np.zeros(8)], [lambda: big]), (4, [np.ones(2)],
                                                [lambda: big[1]]),
            (5, [np.ones(2)], [lambda: None])]
    assert check.shared_buffers(held) == [2, 4]


def test_full_configurations_match_their_sources():
    ec = Cell("ec_solvent.fft_blocks").config
    assert sum(s["count"] * len(s["atoms"]) for s in ec["species"]) == 3680
    assert ec["n_frames"] == 65536
    dh = Cell("dhfr_jac.fft_full").config
    assert sum(s["count"] * len(s["atoms"]) for s in dh["species"]) == 23558
    water = [s for s in dh["species"] if s["resname"] == "WAT"]
    assert water[0]["count"] == 7023


# --- discovery of files a later change adds ---------------------------------

def test_added_cell_config_and_metric_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "perfbench/configs/ec_solvent.json")
                        .read_text())
    config["name"] = "ec_small"
    config["species"][0]["count"] = 3
    config["n_frames"] = 256
    (tmp_path / "perfbench/configs/ec_small.json").write_text(
        json.dumps(config))
    workload = json.loads(
        (ROOT / "perfbench/workloads/ec_solvent.fft_blocks.json")
        .read_text())
    workload["config"] = "ec_small"
    workload["frames"]["block"] = 64
    (tmp_path / "perfbench/workloads/ec_small.blocks.json").write_text(
        json.dumps(workload))
    (tmp_path / "perfbench/metrics/request_count.py").write_text(
        "def read(record):\n    return float(len(record['requests']))\n")
    bench["configs"].append({
        "name": "ec_small", "source": "https://example.org/ec",
        "file": "perfbench/configs/ec_small.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "ec_small.blocks", "config": "ec_small",
        "traffic": "blocks", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "request_count", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "host feed",
        "moves": "afl_rate", "workloads": ["ec_small.blocks"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = Cell("ec_small.blocks", root=tmp_path,
                bench_dir=tmp_path / "perfbench")
    assert cell.config["n_frames"] == 256
    # the accepted metrics list their cells; the new one lists the new cell
    assert [m["name"] for m in cell.per_layer] == ["request_count"]
    assert cell.readers()["request_count"](synthetic_record()) == 2.0

    from perfbench.harness import run_cell

    result = run_cell(cell, SEED, 0.3, False, device="cpu",
                      log=lambda *a: None)
    assert result["correct"], result["checked"]
    assert result["attempted"] >= 2


# --- guards ------------------------------------------------------------------

def test_import_guard_compares_top_level_names_whole():
    assert guard.loaded_forbidden(["transport_analysis_tpu_torch.ops",
                                   "transport_analysis_tpu_torchx",
                                   "numpy"]) == []
    assert guard.loaded_forbidden(["jax.numpy", "flax",
                                   "transport_analysis_tpu.ops.acf",
                                   "jaxlib.xla_client", "jaxx"]) == \
        ["flax", "jax", "jaxlib", "transport_analysis_tpu"]


def test_benchmark_sources_import_nothing_forbidden(tmp_path):
    assert guard.scan(ROOT / "perfbench") == []
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "perfbench/metrics/bad.py").write_text(
        "from jax import numpy\n")
    (tmp_path / "perfbench/reference.py").write_text(
        (tmp_path / "perfbench/reference.py").read_text()
        + "\nimport transport_analysis_tpu_torch.ops\n")
    assert guard.scan(tmp_path / "perfbench") == [
        "metrics/bad.py: jax",
        "reference.py: transport_analysis_tpu_torch"]


def test_run_exits_before_measuring_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
         "ec_solvent.fft_blocks", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_run_exits_where_only_the_benchmark_is(tmp_path):
    """A checkout of BENCHMARK.json and perfbench/ alone has no program:
    the run fails with no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ec_solvent.fft_blocks", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def fake_card(monkeypatch, result):
    import torch

    from perfbench import harness, run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: result)
    return run


def fake_result():
    return {"correct": True, "attempted": 3, "failed": 0, "errors": [],
            "memory_peak_bytes": 1, "window_s": 1.0,
            "end_to_end": {"afl_rate": 1.0, "peak_dev_gib": 1.0,
                           "setup_s": 1.0},
            "checked": {"vacf_series": {"value": 1e-14, "limit": 1e-8}}}


def test_run_prints_the_result_line_last(monkeypatch, capsys):
    run = fake_card(monkeypatch, fake_result())
    assert run.main(["--workload", "ec_solvent.fft_blocks", "--seed", "3",
                     "--seconds", "1", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checked"
    assert set(line["metrics"]) == {"afl_rate", "peak_dev_gib", "setup_s"}
    assert line["device"]["platform"] == "gpu"


def test_run_refuses_when_jax_was_loaded(monkeypatch, capsys):
    run = fake_card(monkeypatch, fake_result())
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "dhfr_jac.fft_full", "--seed", "3",
                     "--seconds", "1", "--trace", "0"]) != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "jax" in captured.err


@pytest.mark.parametrize("name", CELLS)
def test_cells_report_what_the_contract_asks(name):
    cell = Cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "afl_rate", "peak_dev_gib"} <= e2e
    assert cell.per_layer
    assert set(cell.traffic["limits"]) == {
        f"{a['kind']}_{n}" for a in cell.traffic["analyses"]
        for n in ("series", "particles",
                  "d" if a["kind"] == "vacf" else "eta")}
    assert all(0 < v < 1e-6 for v in cell.traffic["limits"].values())
    assert not math.isnan(cell.chips)
