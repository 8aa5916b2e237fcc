"""Multi-device execution, the port's counterpart of ``repro.parallel``:
the microbatch pipeline runtime (:mod:`repro_torch.parallel.pipeline`),
the name-based sharding rules (:mod:`repro_torch.parallel.sharding`) and
the op-level accounting of a step (:mod:`repro_torch.parallel.op_analysis`,
the counterpart of the reference's ``hlo_analysis``, which parses XLA's
optimized HLO text: the port counts the eager ops a step runs)."""
