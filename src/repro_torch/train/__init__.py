"""repro_torch.train — the train step (:mod:`repro_torch.train.step`)."""
