"""Multi-device execution: the microbatch pipeline runtime
(:mod:`repro_torch.parallel.pipeline`), the port's counterpart of
``repro.parallel``. The reference's name-based sharding rules
(``repro.parallel.sharding``) and XLA tooling (``hlo_analysis``) are not
ported yet."""
