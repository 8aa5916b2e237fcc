"""The port's training step against the reference's for the audio-codes
(musicgen), vision-embeds with M-RoPE (qwen2-vl), hybrid (zamba2: Mamba2
and the shared attention block) and SSM (xlstm: mLSTM, sLSTM) configs,
as ``tests/test_torch_train_step.py`` does for the attention configs.
The Mamba2 scan runs the chunk body under autograd (the SSD kernel has
no backward); the sLSTM's Python loop and the mLSTM's chunked form
differentiate as written."""

import pytest

from torch_parity import check_train_parity, ref_train_run


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-72b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_loss_gradients_and_train_step_match_reference(arch):
    check_train_parity(arch, ref_train_run(arch))
