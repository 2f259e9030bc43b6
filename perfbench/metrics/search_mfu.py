"""The whole search step's useful operations (``roofline.hybrid_batch_flops``
over the traced batches) over the traced window at 989 TFLOP/s (bf16,
dense, 700 W), in percent."""

from perfbench.roofline import PEAK_BF16_FLOPS


def read(record):
    if not record.get("useful_flops") or not record.get("window_s"):
        return None
    return 100.0 * record["useful_flops"] / (record["window_s"] * PEAK_BF16_FLOPS)
