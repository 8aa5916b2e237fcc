"""The kernel ops have no backward, and the Mamba2 scan's route under
autograd.

``flash_attention`` and ``ssm_scan`` raise where autograd would record
them, on the CPU as on the card (the reference's Pallas kernels cannot
be differentiated either); under ``no_grad``, or with no input that
requires grad, they run. ``mamba_scan`` takes the chunk body wherever
autograd records, so a Mamba2 layer differentiates on any device; the
mixers' gradients equal the reference's ``jax.grad`` (``tests/
test_torch_train_step.py`` holds whole models)."""

import pytest
import torch

from torch_parity import grad_op_inputs


@pytest.mark.parametrize("op", ["flash_attention", "ssm_scan"])
def test_kernel_ops_refuse_autograd(op):
    q, call = grad_op_inputs(op, "cpu")
    plain = call()
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{op} has no backward"):
        call()
    with torch.no_grad():
        assert torch.equal(call(), plain)


@pytest.mark.parametrize("op", ["flash_attention", "ssm_scan"])
def test_kernel_ops_run_where_nothing_requires_grad(op):
    """Grad mode alone does not refuse: only an input that requires grad."""
    _, call = grad_op_inputs(op, "cpu")
    assert torch.is_grad_enabled()
    out = call()
    assert torch.isfinite(out).all() and not out.requires_grad


def test_mamba_scan_routes_to_the_chunk_body_under_autograd(monkeypatch):
    """With an input that requires grad, ``mamba_scan`` never calls the
    kernel op, whatever the device; under ``no_grad`` a CUDA-typed call
    would reach it (stubbed here: no card)."""
    from repro_torch.models import ssm as S_

    calls = []
    monkeypatch.setattr(S_, "ssm_scan", lambda *a, **k: calls.append(a) or a[0])
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 12, 2, 4), generator=g, requires_grad=True)
    b, c = torch.randn((1, 12, 3), generator=g), torch.randn((1, 12, 3), generator=g)
    dt = torch.rand((1, 12, 2), generator=g)
    y = S_.mamba_scan(x, b, c, -dt, dt, 4)
    assert y.requires_grad and calls == []
    torch.testing.assert_close(y, S_.mamba_scan_plain(x, b, c, -dt, dt, 4), rtol=0, atol=0)


def test_train_step_through_the_flash_kernel_raises():
    """``use_flash_kernel=True`` routes training attention into the kernel
    op, which refuses autograd, as ``jax.grad`` through the reference's
    Pallas kernel fails; the reference trains on the chunked core."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    cfg = replace(get_config("deepseek-7b").reduced(), use_flash_kernel=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        make_train_step(cfg)(model, adamw_init(model), SyntheticLMData(cfg, 2, 16).batch_at(0))
