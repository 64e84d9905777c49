from repro_torch.optim.adamw import AdamW, AdamWState, linear_scaling, \
    warmup_cosine

__all__ = ["AdamW", "AdamWState", "linear_scaling", "warmup_cosine"]
