"""The harness's arithmetic and the benchmark's contract, on the CPU: the
window's rate, the idle share from a union of kernel intervals, the
reservoir, the names and units of ``BENCHMARK.json``, which metrics each
cell reports, and which modules the benchmark's files import."""

import ast
import copy
import importlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_window_rate_is_taken_over_the_whole_window():
    durations = iter([0.05, 0.12, 0.05, 0.05, 0.05])

    def request(i, seed):
        time.sleep(next(durations))
        return {"i": i, "seed": seed}

    out = harness.run_window(request, 0.15, seed=7)
    # requests start until 0.15 s have passed: 0.05, 0.17 -> two more do not start
    assert [r["i"] for r in out["results"]] == [0, 1]
    assert out["window_s"] >= 0.17
    assert out["window_s"] == pytest.approx(sum(r["seconds"] for r in out["results"]), abs=0.01)
    seeds = [r["seed"] for r in out["results"]]
    assert seeds == [harness.request_seed(7, 0), harness.request_seed(7, 1)]
    assert len(set(seeds)) == 2 and all(0 <= s < 2**31 for s in seeds)


def test_idle_share_counts_a_stall_once_from_the_union_of_kernels():
    ms = 1_000_000
    events = [
        ("bench.slice", False, 0, 100 * ms, True),
        ("bench.slice", True, 0, 100 * ms, True),  # the range on the device's timeline
        ("unet_call.b2", False, 0, 60 * ms, True),
        ("aten::mm", False, 1 * ms, 2 * ms, False),
        ("gemm_kernel", True, 2 * ms, 30 * ms, False),
        ("elementwise_kernel", True, 20 * ms, 40 * ms, False),  # overlaps the GEMM
        ("aten::group_norm", False, 55 * ms, 70 * ms, False),  # the host stalls here
        ("flash_fwd_kernel", True, 80 * ms, 95 * ms, False),
    ]
    out = harness.reduce_trace(events, "bench.slice")
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.038 + 0.015)
    assert out["by_class"]["gemm"] == pytest.approx(0.028)
    assert out["by_class"]["flash_attention"] == pytest.approx(0.015)
    assert "bench.slice" not in out["by_name"]
    assert sum(out["gaps"].values()) == pytest.approx(0.1 - 0.053)
    # each gap goes to what the host was in at its start
    assert out["gaps"] == pytest.approx({"unet_call.b2": 0.002 + 0.040, "host": 0.005})


def test_reservoir_keeps_a_seeded_uniform_sample_in_reused_slots():
    def run(seed, n):
        r = harness.Reservoir(2, seed)
        slots_used = set()
        for i in range(n):
            slots_used.add(r.current)
            r.offer({"i": i})
        return r, slots_used

    a, used = run(11, 9)
    b, _ = run(11, 9)
    assert [k["index"] for k in a.kept] == [k["index"] for k in b.kept]
    assert used <= {0, 1, 2} and len({k["slot"] for k in a.kept} | {a.current}) == 3
    counts = [0] * 6
    for seed in range(600):
        for k in run(seed, 6)[0].kept:
            counts[k["index"]] += 1
    assert min(counts) > 140 and max(counts) < 260  # 200 each


def test_a_metric_without_a_file_of_its_own_is_read_by_its_quantity():
    sl = {"window_s": 2.0, "busy_s": 1.5, "by_class": {"norm": 0.01, "elementwise/copy": 0.03},
          "unet_calls": 4}
    assert harness.read_metric("device_idle_pct.clip", {"slice": sl}) == pytest.approx(25.0)
    assert harness.read_metric("eager_ms_per_call.image", {"slice": sl}) == pytest.approx(10.0)
    assert harness.read_metric("device_idle_pct.image", {"slice": {}}) is None
    with pytest.raises(FileNotFoundError):
        harness.read_metric("no_such_metric.image", {})


def test_judge_holds_every_number_to_its_limit_and_every_request_to_its_path():
    limits = {"a": 0.1, "b": 0.0}
    assert harness.judge({"a": 0.05, "b": 0.0}, limits, 0) == (
        True, {"a": [0.05, 0.1], "b": [0.0, 0.0], "missed_kernel_path": [0, 0]})
    assert not harness.judge({"a": 0.05, "b": 0.0}, limits, 1)[0]
    assert not harness.judge({"a": 0.2, "b": 0.0}, limits, 0)[0]
    assert not harness.judge({"a": float("nan"), "b": 0.0}, limits, 0)[0]
    assert not harness.judge({"a": 0.0, "c": 0.0}, limits, 0)[0]  # a number with no limit
    assert not harness.judge({}, limits, 0)[0]


def test_window_logs_what_the_host_spent_on_each_request():
    def request(i, seed):
        start = time.thread_time()
        while time.thread_time() - start < 0.03:  # CPU work on the launching thread, past
            sum(range(10_000))  # a clock that ticks in 10 ms
        time.sleep(0.02)
        return {}

    out = harness.run_window(request, 0.01, seed=3)
    host = out["results"][0]["host"]
    assert 0 < host["cpu_s"] < out["results"][0]["seconds"]
    assert host["preempted"] >= 0 and host["steal_s"] >= 0


def test_names_units_and_shapes_of_the_benchmark_file():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in SPEC["configs"]:
        assert (BENCH.parent / c["file"]).is_file() and c["source"].startswith("https://")
        assert json.loads((BENCH.parent / c["file"]).read_text())["source"] == c["source"]
    for w in SPEC["workloads"]:
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file() and w["chips"] == 1
        assert len(w["why"]) <= 200


def unmatched_limits(wl: dict, cfg: dict) -> set:
    """The names in the workload's ``limits`` or among the numbers its
    system's check compares, but not in both."""
    driver = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    return set(wl["limits"]) ^ set(driver.System.compares(wl))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")}
    layer = harness.cell_metrics(SPEC, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 3 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert any((BENCH / "metrics" / f"{n}.py").is_file() for n in (m["name"], m["name"].split(".")[0]))
    wl, cfg = harness.load_cell(cell)
    assert not unmatched_limits(wl, cfg)


@pytest.mark.parametrize("cell, key", [("sdxl-fusion-n3-langsam.segment", "update_rel"),
                                       ("sdxl-fusion-n3.bf16-1seed", "box_abs"),
                                       ("i2vgen-xl.bf16-clip", "preview_abs")])
def test_a_limit_its_check_does_not_compare_fails_the_cell(cell, key):
    wl, cfg = copy.deepcopy(harness.load_cell(cell))
    wl["limits"][key] = 1.0
    assert unmatched_limits(wl, cfg) == {key}
    del wl["limits"][key]
    compared = next(iter(wl["limits"]))
    del wl["limits"][compared]  # a number compared with no limit
    assert unmatched_limits(wl, cfg) == {compared}


def imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = set(imports_of(path)) & {"jax", "jaxlib", "flax", "tweediemix_tpu"}
        assert not found, (path, found)
    for path in sorted((BENCH / "reference").rglob("*.py")):
        found = set(imports_of(path)) & {"tweediemix_tpu_torch"}
        assert not found, (path, found)
        assert not any(m.startswith("benchmark.systems") for m in
                       (n.module or "" for n in ast.walk(ast.parse(path.read_text()))
                        if isinstance(n, ast.ImportFrom)))


def test_the_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules({"tweediemix_tpu_torch.ops": None, "torch": None}) == []
    assert harness.forbidden_modules({"tweediemix_tpu.models": None, "jax.numpy": None}) == [
        "jax", "tweediemix_tpu"]


def test_a_run_without_the_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          SPEC["workloads"][0]["name"], "--seed", str(2**32 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_recorder_slots_are_allocated_in_set_up_and_counted_whole():
    import torch

    from benchmark.systems.record import Recorder

    rec = Recorder(3, 2, (1, 4), (2, 4), (1, 8), (1, 4), torch.device("cpu"),
                   take_x=lambda x: x[:1], key=lambda x, t, args, eps: (int(t), eps.shape[0]))
    fixed = 4 * 3 * (2 * 4 + 2 * 8 + 8 + 4)
    assert rec.bytes == fixed
    layer = torch.nn.Linear(4, 4)
    rec.watch(layer, rows=1)
    unet = rec.wrap(lambda x, t: layer(x))
    unet(torch.ones(2, 4), 5)  # the warm-up: the watched layer's slots appear, nothing kept
    assert rec.bytes == fixed + 4 * 3 * 2 * (4 + 4) and rec.meta == [[], [], []]
    rec.begin(1)
    x = torch.randn(2, 4)
    unet(x, 7)
    rec.end(torch.zeros(1, 8), torch.ones(1, 4))
    assert rec.meta[1] == [(7, 2)] and torch.equal(rec.x[1, 0], x[:1])
    assert torch.equal(rec.site_x[1, 0], x[:1]) and torch.allclose(rec.site_y[1, 0], layer(x[:1]))
    assert torch.equal(rec.latents[1], torch.ones(1, 4))
