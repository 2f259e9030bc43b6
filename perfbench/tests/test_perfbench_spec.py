"""BENCHMARK.json and the files it names; the readers; the run's refusal
without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import spec

ROOT = Path(__file__).resolve().parents[2]


def test_every_name_has_its_file():
    b = spec.benchmark()
    for w in b["workloads"]:
        cell = spec.cell(w["name"], b)
        assert cell["cfg"]["system"] and cell["mix"]["loop"]
        assert set(cell["cfg"]["check"]["limits"])
        assert (ROOT / "perfbench" / "systems" / f"{cell['cfg']['system']}.py").exists()
        assert (ROOT / "perfbench" / "loops" / f"{cell['mix']['loop']}.py").exists()
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_readers_on_a_record():
    record = {
        "batches": 4, "window_s": 2.0, "busy_s": 1.5, "device_ops": 400, "rerank_depth": 100,
        "host_s": {"prepare": 0.2}, "span_calls": {"prepare": 4},
        "device_s": {"encoder.dpr": 0.1, "encoder.splade": 0.1, "encoder.colbert": 0.2, "leg.bm25": 0.04,
                     "leg.dpr": 0.12, "leg.splade": 0.2, "leg.colbert": 0.6, "rerank": 1.0},
        "kernel_s": {"K1": 0.4}, "k1_bound_s": 0.1, "useful_flops": 989e12 * 0.5,
    }
    want = {"host_prepare_ms": 50.0, "device_ops_per_batch": 100.0, "encoder_device_ms": 100.0,
            "legs_device_ms": 240.0, "rerank_device_ms": 250.0, "k1_roofline": 25.0,
            "search_mfu": 25.0, "device_idle_share": 25.0}
    for name, value in want.items():
        assert spec.reader(name)(record) == pytest.approx(value), name
    assert spec.reader("rerank_device_ms")({**record, "rerank_depth": 0}) is None
    assert spec.reader("k1_roofline")({"kernel_s": {}}) is None


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", json.load(open(ROOT / "BENCHMARK.json"))["workloads"][0]["name"],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
