"""repro_torch.optim — AdamW (:mod:`repro_torch.optim.adamw`)."""
