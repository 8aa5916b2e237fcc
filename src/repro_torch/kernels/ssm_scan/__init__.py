"""Chunked Mamba2 SSD scan: the CUDA kernel (``csrc/ssm_scan.cu``), its
wrapper and chunked plain version (:mod:`.kernel`), the model-layout op
(:mod:`.ops`) and the sequential oracle (:mod:`.ref`)."""
