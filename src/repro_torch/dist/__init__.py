"""repro_torch.dist — the slab-sharded LBM engine (:mod:`repro_torch.dist.lbm`)."""
