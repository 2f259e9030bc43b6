"""``fusion_tpu_torch/utils/profiling.py`` against the JAX package's module:
``StageTimer``'s report keys, ``flops_of`` against the analytic count of a
tiny encoder's forward, ``mfu_report`` on a loop (its body counted once per
trip), the peak and its override, ``trace`` writing a TensorBoard trace, and
the analytic step counts that ``chip_smoke.py`` and
``tools/bench_colbert_train.py`` read (at CamemBERT-base, the numbers they
printed before the counts moved here)."""

import os

import pytest
import torch

from fusion_tpu.utils import profiling as jax_profiling
from fusion_tpu_torch.models.encoder import Encoder, EncoderConfig, init_weights, place
from fusion_tpu_torch.utils import profiling


def test_stage_timer_reports_jax_keys():
    want, got = jax_profiling.StageTimer(), profiling.StageTimer()
    for timer in (want, got):
        for name in ("encode", "score", "encode"):
            with timer.stage(name):
                pass
    assert list(got.report(num_queries=64)) == list(want.report(num_queries=64))
    assert got.report() == {k: v * 64 for k, v in got.report(64).items()}
    x = torch.ones(3)
    with got.stage("fenced", fence=x):  # a CPU tensor: nothing to wait for
        x = x * 2
    assert set(got.totals) == {"encode", "score", "fenced"}


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


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files


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
