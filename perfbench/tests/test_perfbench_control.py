"""The control (the reference in float8 e4m3, one precision below the
configuration's bfloat16, in the program's place) comes out not correct,
and planted faults in the timed path make a run not correct."""

import time

import pytest

from perfbench import check
from perfbench.control import control_readings
from perfbench.faults import planted
from perfbench.run import run_cell
from perfbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("traffic", ["rerank-b64", "retrieve-b256"])
def test_the_control_is_not_correct(traffic):
    cell = tiny_cell(traffic)
    out = run_cell(cell, 2**31 + 3, 0.2, False, device="cpu", t0=time.perf_counter(), keep=True)
    kept = out.pop("_keep")
    ok, table = check.verdict(control_readings(kept, cell["cfg"], cell["mix"], "cpu"), cell["cfg"]["check"]["limits"])
    assert not ok, table


@pytest.mark.parametrize("fault,traffic", [
    ("colbert_answer", "retrieve-b256"),
    ("fused_answer", "retrieve-b256"),
    ("fused_answer", "rerank-b64"),
    ("head_answer", "rerank-b64"),
])
def test_a_planted_fault_is_caught(fault, traffic):
    with planted(fault):
        out = run_cell(tiny_cell(traffic), 2**31 + 5, 0.2, False, device="cpu", t0=time.perf_counter())
    assert not out["correct"], out["checks"]


def test_the_open_loop_serves_and_checks_its_replies():
    cell = tiny_cell("serve-open", rate=30.0, check_within_s=0.5, check_requests=4, max_batch=8)
    out = run_cell(cell, 2**31 + 1, 1.5, False, device="cpu", t0=time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and "rerank.err.median" in out["checks"], out
    with planted("head_answer"):
        out = run_cell(cell, 2**31 + 1, 1.5, False, device="cpu", t0=time.perf_counter())
    assert not out["correct"]


@pytest.mark.parametrize("traffic,variant", [
    ("rerank-b64", "int8_path"),
    ("retrieve-b256", "int8_path"),
    ("rerank-b64", "int8_rerank"),
])
def test_the_programs_int8_path_is_not_correct(traffic, variant):
    """The control where the program has a lower-precision path of its own:
    its int8 corpus rows, BM25 impacts, query encoders and cross-encoder
    (``int8_path``), or the cross-encoder's int8 view alone (``int8_rerank``),
    which only the rerank's numbers can catch."""
    cell = tiny_cell(traffic)
    if variant == "int8_rerank":
        # the 32-wide tiny trunk gives int8 codes little to round: at 128
        # wide, with the cross-encoder's logits spread, they read above the
        # rerank's limits, as the 768-wide trunk's do on the card
        cell["cfg"]["encoder"].update(hidden_size=128, intermediate_size=256)
        cell["cfg"]["weights"]["cross_std"] = 0.5
    out = run_cell(cell, 2**31 + 3, 0.2, False, device="cpu", t0=time.perf_counter(), variant=variant)
    assert not out["correct"], out["checks"]
    if variant == "int8_rerank":
        assert all(row["value"] <= row["limit"] for name, row in out["checks"].items()
                   if not name.startswith("rerank")), out["checks"]
