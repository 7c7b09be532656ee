"""repro_torch.dist — the slab-sharded LBM engine (:mod:`repro_torch.dist.lbm`),
gradient compression (:mod:`~repro_torch.dist.compress`) and the
fault-tolerance shims (:mod:`~repro_torch.dist.ft`)."""
