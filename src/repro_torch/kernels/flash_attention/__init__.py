"""Causal flash attention: the CUDA kernel (``csrc/flash_attention.cu``),
its wrapper (:mod:`.ops`) and its plain PyTorch version (:mod:`.ref`)."""
