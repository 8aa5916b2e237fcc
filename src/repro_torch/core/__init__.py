"""Planning core of the port: cost model, profiles, DP kernels, sweep.

The submodules are imported by name (``from repro_torch.core.sweep import
sweep``); nothing is re-exported here, so ``repro_torch.core.sweep``
always resolves to the module."""
