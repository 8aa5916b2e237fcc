"""Multi-device execution, the port's counterpart of ``repro.parallel``:
the microbatch pipeline runtime (:mod:`repro_torch.parallel.pipeline`)
and the name-based sharding rules (:mod:`repro_torch.parallel.sharding`).
The reference's ``hlo_analysis`` parses XLA's optimized HLO text; the
port compiles no program, so it has no counterpart."""
