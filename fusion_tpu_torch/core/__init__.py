from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists

__all__ = ["RankedLists", "PAD_ID"]
