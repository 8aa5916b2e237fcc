"""Int8 GEMMs: the W8A8 and W8A16 CUDA kernels (``csrc/quant_matmul.cu``),
their wrappers and plain versions (:mod:`.kernel`), the public ops
(:mod:`.ops`) and the reference arithmetic (:mod:`.ref`)."""
