"""One ColBERT training step at the reference's preset scale, on one card.

The counterpart of ``scripts/bench_colbert_train.py``: batch 128, n-way 8
(1 positive + 7 negatives), query 32, doc 256, projection dim 128, a
CamemBERT-base trunk at dropout 0 in bf16 over f32 master weights with
per-layer remat, AdamW at a constant lr 5e-6, the CE loss; the same random
token batch from ``np.random.default_rng(0)``.  It times the whole step (3
encoder forwards + batched n-way MaxSim + loss + backward + AdamW update)
with CUDA events over ``--steps`` steps after one warm-up step.  Its FLOPs
and MFU come from ``utils/profiling.py`` (``colbert_step_flops``, against
the H100's dense bf16 peak).

``--attention flash`` trains through the hand-written attention kernels:
each layer's forward runs FA in residual mode (and again in the remat
recompute) and its backward FA-bwd, so a step launches FA 2 × 3 × 12 = 72
times and FA-bwd 36 times (the launches are in the record).

Run on the card (one JSON line, the script's fields and the port's):
    python -m fusion_tpu_torch.tools.bench_colbert_train [--attention flash] [--steps 8]
``--tiny --device cpu`` runs the CPU smoke shapes.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nway", type=int, default=8)
    ap.add_argument("--query_len", type=int, default=32)
    ap.add_argument("--doc_len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tiny", action="store_true", help="CPU smoke shapes")
    ap.add_argument("--attention", default="einsum", choices=["einsum", "einsum_bf16", "flash"],
                    help="flash = the hand-written attention kernels, forward and backward")
    ap.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (--tiny smoke runs)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(model, step function, state, device batch, config) for ``args``."""
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig
    from fusion_tpu_torch.train.trainer import FitConfig, _to_device, init_train_state, make_colbert_train_step

    device = resolve_device(args.device)
    if args.tiny:
        cfg = EncoderConfig.tiny(vocab_size=1024, attention_impl=args.attention)
        args.batch, args.doc_len = 4, 32
    else:
        # CamemBERT-base; remat keeps the 896-doc negative forward's
        # activations to one layer's
        cfg = EncoderConfig(dropout=0.0, dtype=torch.bfloat16, remat=True, attention_impl=args.attention)
    bs, npq, lq, ld = args.batch, args.nway - 1, args.query_len, args.doc_len
    model = ColBERT(cfg, dim=16 if args.tiny else 128, max_query_length=lq, max_doc_length=ld, device=device,
                    param_dtype=torch.float32)
    state, tx, _ = init_train_state(model, FitConfig(steps=args.steps, learning_rate=5e-6, scheduler="constant"))
    step_fn = make_colbert_train_step(model, tx, loss_name="ce")
    rng = np.random.default_rng(0)

    def tok(n, length):
        return rng.integers(5, cfg.vocab_size, size=(n, length), dtype=np.int32), np.ones((n, length), np.float32)

    (qi, qm), (pi, pm), (ni, nm) = tok(bs, lq), tok(bs, ld), tok(bs * npq, ld)
    batch = _to_device({"query_ids": qi, "query_mask": qm, "pos_ids": pi, "pos_mask": pm,
                        "neg_ids": ni, "neg_mask": nm}, model.device)
    return model, step_fn, state, batch, cfg


def traced_step(fn, top: int = 8) -> dict:
    """One traced call of ``fn`` on the card: its device time, the share of
    its wall time the device was busy, and the device operations that took
    most of it (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in events) / 1000
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return {"device_ms": dev_ms, "wall_ms": wall_ms, "busy_share": dev_ms / wall_ms,
            "top": [(e.key[:60], round(e.self_device_time_total / 1000, 2), e.count) for e in ranked]}


def run(args: argparse.Namespace, trace: bool = False) -> dict:
    """Warm up, time ``args.steps`` steps (and with ``trace``, on the card,
    trace one more); returns the JSON record."""
    from fusion_tpu_torch.ops.attention import masked_attention_backward_cuda, masked_attention_cuda
    from fusion_tpu_torch.utils import profiling

    model, step_fn, state, batch, cfg = setup(args)
    cuda = model.device.type == "cuda"
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    losses = [float(metrics["loss"])]
    first_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fa0, bwd0 = masked_attention_cuda.launches, masked_attention_backward_cuda.launches
    t0 = time.perf_counter()
    if cuda:
        start.record()
    for _ in range(args.steps):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
    if cuda:
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1000 / args.steps
    else:
        dt = (time.perf_counter() - t0) / args.steps
    fa = (masked_attention_cuda.launches - fa0) / args.steps
    fa_bwd = (masked_attention_backward_cuda.launches - bwd0) / args.steps
    traced = None
    if trace and cuda:
        box = [state]

        def one_step():
            box[0], _ = step_fn(box[0], batch)

        traced = traced_step(one_step)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite ColBERT train loss: {losses}")
    bs, lq, ld = args.batch, args.query_len, args.doc_len
    useful, hardware = profiling.colbert_step_flops(cfg, bs, args.nway, lq, ld, model.dim)
    detail = {
        "batch": bs, "nway": args.nway, "query_len": lq, "doc_len": ld, "steps": args.steps,
        "examples_per_s": bs / dt,
        "tokens_per_step": bs * (lq + ld * args.nway),
        "attention": args.attention,
        "device": torch.cuda.get_device_name(model.device) if cuda else "cpu",
        "first_step_s": first_s,
        "useful_tflop_per_step": useful / 1e12,
        "hw_tflop_per_step": hardware / 1e12,
        "useful_tflops_per_s": useful / dt / 1e12 if cuda else None,
        "hw_tflops_per_s": hardware / dt / 1e12 if cuda else None,
        "useful_mfu": profiling.utilization(useful, dt) if cuda else None,
        "mfu_hw": profiling.utilization(hardware, dt) if cuda else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated(model.device) / 2**30 if cuda else None,
        "fa_launches_per_step": fa,
        "fa_bwd_launches_per_step": fa_bwd,
        "losses": losses,
        "traced_step": traced,
    }
    return {"metric": "colbert_train_step_ms", "value": dt * 1000, "unit": "ms/step", "detail": detail}


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
