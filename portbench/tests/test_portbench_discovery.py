"""The harness finds each configuration, traffic mix, per-layer metric
and set of limits by name, and takes up new ones added as files."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import bench

from .small import small

REPO = Path(bench.__file__).resolve().parent.parent
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_name_in_the_spec_has_its_file():
    b = bench.Bench()
    for c in b.spec["configs"]:
        assert b.config(c["name"])["name"] == c["name"]
        assert (REPO / c["file"]).is_file()
    for w in b.spec["workloads"]:
        assert b.traffic(w["traffic"])["loop"] in ("engine", "artifact")
        assert (b.root / "limits" / f"{w['name']}.json").is_file()
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric whose end-to-end metric it reports
        e2e = {m["name"] for m in b.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = b.per_layer(w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)
    for m in b.spec["per_layer"]:
        assert callable(b.reader(m["name"]))


def test_new_files_are_taken_up_without_editing(tmp_path):
    """A cell, a configuration, a mix and a metric added as new files
    (and entries) are found; no file that exists changes."""
    root = tmp_path / "portbench"
    shutil.copytree(bench.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    spec = json.loads(bench.SPEC.read_text())
    cfg = json.loads((root / "configs" / "headline.json").read_text())
    (root / "configs" / "headline_small.json").write_text(json.dumps(
        dict(cfg, name="headline_small", **small("headline"))))
    traffic = json.loads((root / "traffic" / "served.json").read_text())
    (root / "traffic" / "burst.json").write_text(json.dumps(
        dict(traffic, warmup=1, sample=1)))
    (root / "metrics" / "items.served.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['items'])\n")
    shutil.copy(root / "limits" / "headline.served.json",
                root / "limits" / "headline_small.burst.json")
    spec["workloads"].append(dict(name="headline_small.burst",
                                  config="headline_small", traffic="burst",
                                  chips=1, why="test"))
    for m in spec["end_to_end"]:
        if "workloads" in m and "headline.served" in m["workloads"]:
            m["workloads"].append("headline_small.burst")
    spec["per_layer"].append(dict(name="items.served", unit="items",
                                  better="higher", source="host_clock",
                                  layer="serving: request",
                                  moves="request_ms",
                                  workloads=["headline_small.burst"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = bench.Bench(root, tmp_path / "BENCHMARK.json")
    assert b.config("headline_small")["instances"] == 16
    out = bench.run_cell("headline_small.burst", 5, 0.3, True,
                         t_start=time.perf_counter(), device="cpu", bench=b)
    assert out["metrics"]["items.served"]["value"] == out["attempted"]
    assert all(p.read_bytes() == v for p, v in before.items())


@pytest.mark.parametrize("workload", ["headline.orbit", "headline.served"])
@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_contract_keys(workload, traced):
    out = bench.run_cell(workload, 2**31 + 17, 0.3, traced,
                         t_start=time.perf_counter(), device="cpu",
                         overrides=small(workload))
    keys = list(out)
    assert keys[:5] == CONTRACT_KEYS and keys[-1] == "checks"
    assert set(keys) == set(CONTRACT_KEYS + ["checks"]
                            + (["breakdown"] if traced else []))
    assert set(out["device"]) == ({"platform", "kind", "count",
                                   "memory_peak_bytes"}
                                  | ({"busy_s", "window_s"} if traced
                                     else set()))
    b = bench.Bench()
    want = ({m["name"] for m in b.per_layer(workload)} if traced
            else {m["name"] for m in b.end_to_end(workload)})
    # on the CPU no device trace exists: its per-layer metrics are absent
    assert set(out["metrics"]) <= want
    if not traced:
        assert set(out["metrics"]) == want
    assert out["correct"] is True and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_no_card_no_result():
    """Without the CUDA devices a cell asks for, the command exits
    non-zero and prints no result."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "headline.served", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
