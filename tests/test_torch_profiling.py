"""``fusion_tpu_torch/utils/profiling.py``: the program's spans and
counters (off by default, on under ``tracing()``, read by ``snapshot()``),
``flops_of`` against the analytic count of a tiny encoder's forward,
``mfu_report`` on a loop (its body counted once per trip), the peak and its
override, ``trace`` writing a TensorBoard trace with the spans on, and the
analytic step counts that ``chip_smoke.py`` and
``tools/bench_colbert_train.py`` read (at CamemBERT-base, the numbers they
printed before the counts moved here)."""

import os
import threading
import time

import pytest
import torch

from fusion_tpu_torch.models.encoder import Encoder, EncoderConfig, init_weights, place
from fusion_tpu_torch.utils import profiling


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


def test_span_off_builds_no_record_function(monkeypatch, clean):
    built = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **kw: built.append(a))
    assert not profiling.enabled()
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second  # the one shared null context
    with first:
        profiling.count("n", 3)
        assert profiling.current() is None
    assert built == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}, "events": []}


def test_span_records_host_time_calls_parent_and_self(clean):
    inside = {}

    def other_thread():
        with profiling.span("worker"):
            inside["worker"] = profiling.current()

    with profiling.tracing():
        assert profiling.enabled()
        for _ in range(2):
            with profiling.span("outer"):
                time.sleep(0.01)
                with profiling.span("inner"):
                    assert profiling.current() == "inner"
                    time.sleep(0.02)
                if "worker" not in inside:  # a span on another thread has its own parents
                    t = threading.Thread(target=other_thread)
                    t.start()
                    t.join(timeout=10)
                    assert not t.is_alive()
        profiling.count("n", 2)
        profiling.count("n", 3)
        profiling.count("device", torch.tensor(4))
    assert not profiling.enabled()
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["calls"] == inner["calls"] == 2 and snap["spans"]["worker"]["calls"] == 1
    assert inner["host_s"] >= 0.04 and outer["host_s"] >= inner["host_s"] + 0.02
    assert inner["self_s"] == inner["host_s"]
    assert outer["self_s"] == pytest.approx(outer["host_s"] - inner["host_s"], abs=1e-6)
    events = snap["events"]
    assert [e[0] for e in events] == ["outer", "inner", "worker", "outer", "inner"]
    assert [e[4] for e in events] == [-1, 0, -1, -1, 3]
    assert events[2][3] != events[0][3] == threading.get_native_id()
    assert all(e[1] <= e[2] for e in events) and inside["worker"] == "worker"
    assert snap["counters"] == {"n": 5, "device": 4}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}, "events": []}


def test_span_agrees_with_its_profiler_range(clean):
    """The record's start and end lie on the trace's clock, within 0.1 ms of
    the span's own range (the best of five spans: a loaded host may
    preempt any one of them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        for _ in range(5):
            with profiling.span("agree"):
                time.sleep(0.002)
    origin = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((origin + round(1000 * e.time_range.start), origin + round(1000 * e.time_range.end))
                    for e in prof.events() if e.name == f"{profiling.PREFIX}.agree")
    spans = sorted((e[1], e[2]) for e in profiling.snapshot()["events"])
    assert len(ranges) == len(spans) == 5
    worst = [max(abs(r0 - s0), abs(r1 - s1)) for (r0, r1), (s0, s1) in zip(ranges, spans)]
    assert min(worst) < 100_000, worst


@pytest.mark.parametrize("length", [8, 24])
def test_flops_of_equals_the_analytic_count_of_an_encoder(length):
    """The counter sees every matmul of the forward: the trunk's linear
    layers and attention's two products (the plain versions on the CPU)."""
    for impl in ("einsum", "flash"):
        cfg = EncoderConfig.tiny(vocab_size=256, hidden_size=32, num_heads=2, num_layers=3, attention_impl=impl)
        module = Encoder(cfg)
        init_weights(module, 0)
        place(module, cfg.dtype, "cpu")
        ids = torch.randint(5, 256, (3, length))
        mask = torch.ones(3, length, dtype=torch.int32)
        with torch.inference_mode():
            counted = profiling.flops_of(module, ids, mask)
        assert counted["flops"] == profiling.encoder_flops(cfg, 3, length), impl
        assert counted["seconds"] > 0


def test_mfu_report_counts_a_loop_body_once_per_trip(monkeypatch):
    a, b = torch.randn(16, 32), torch.randn(32, 8)

    def loop(x, w, trips):
        for _ in range(trips):
            x = torch.cat([x @ w, x[:, 8:]], dim=1)
        return x

    one = profiling.mfu_report(loop, (a, b, 1), 1e-3)
    five = profiling.mfu_report(loop, (a, b, 5), 1e-3)
    assert one["flops"] == 2 * 16 * 32 * 8 and five["flops"] == 5 * one["flops"]
    assert five["tflops_per_s"] == round(five["flops"] / 1e-3 / 1e12, 2)
    assert five["mfu"] == round(five["flops"] / 1e-3 / 1e12 / profiling.peak_tflops(), 4)
    # the hand-written kernels' work, which the counter does not see on the card
    assert profiling.mfu_report(loop, (a, b, 1), 1e-3, hand_flops=100.0)["flops"] == one["flops"] + 100
    assert profiling.mfu_report(lambda: None, (), 1.0) == {}
    assert profiling.peak_tflops() == profiling.DEFAULT_PEAK_TFLOPS == 989.0
    monkeypatch.setenv("FUSION_TPU_TORCH_PEAK_TFLOPS", "500")
    assert profiling.peak_tflops() == 500.0
    assert profiling.utilization(5e14, 1.0) == 1.0


def test_trace_writes_a_tensorboard_trace(tmp_path, clean):
    with profiling.trace(str(tmp_path)):
        assert profiling.enabled()
        with profiling.span("probe"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert not profiling.enabled()
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs if f.endswith(".pt.trace.json")]
    assert files
    with open(files[0]) as f:
        assert f'"{profiling.PREFIX}.probe"' in f.read()


def test_analytic_step_counts_keep_their_numbers():
    """At CamemBERT-base: the bench step's (useful, hardware) FLOPs and the
    four families' [train] counts, as the two scripts computed them before."""
    cfg = EncoderConfig(dtype=torch.bfloat16, remat=True)
    assert profiling.colbert_step_flops(cfg, 128, 8, 32, 256, 128) == (135678016880640.0, 190982431703040.0)
    h, f, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    per_token = 2.0 * layers * (4 * h * h + 2 * h * f)

    def enc(n, length):
        return n * (length * per_token + 4.0 * layers * length * length * h)

    b, lq, ld, n_neg = 128, 32, 256, 1
    tokens = b * lq + b * (1 + n_neg) * ld
    layers_fwd = enc(b, lq) + enc(b * (1 + n_neg), ld)
    heads = tokens * 2 * h * 128 + 2.0 * b * (1 + n_neg) * lq * ld * 128
    model = 3 * (layers_fwd + heads)
    assert profiling.train_step_flops(cfg, "colbert", b, lq, ld, n_neg, 128) == (model, model + layers_fwd)
    mono = profiling.train_step_flops(cfg, "monobert", 32, 0, 256, 0)
    assert mono[0] == 3 * (enc(32, 256) + 32 * (2 * h * h + 2 * h))
    # [train]'s presets, as its last run printed them (model, hardware)
    assert profiling.train_step_flops(cfg, "dpr", 64, 512, 512, 1) == (55662813904896.0, 74217072623616.0)
    assert profiling.train_step_flops(cfg, "splade", 32, 64, 512, 1) == (24870666694656.0, 31408143790080.0)
