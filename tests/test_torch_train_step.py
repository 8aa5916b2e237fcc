"""The port's training step against the reference's
(``repro.models.transformer.loss_fn`` / ``cross_entropy`` /
``param_count``, ``repro.models.layers.moe_aux_loss``,
``repro.launch.steps.make_train_step``), on the reference's weights
(``convert.lm_params_from_reference``) and the same numpy batches, at
``reduced()`` size in float32. The attention configs are here;
``tests/test_torch_train_families.py`` holds the audio, vision, hybrid
and SSM ones. Tolerances are derived in ``tests/torch_parity.py``
(``GRAD_RTOL``, ``assert_first_step_close``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.launch.steps import accumulated_grads, loss_and_grads, make_train_step
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw_init
from torch_parity import check_train_parity, ref_train_run, torch_batch, train_batch, train_pair


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_reference(arch):
    """Full configs: the reference's leaf sizes (``jax.eval_shape``) and
    the port's parameters built under ``FakeTensorMode`` (nothing
    allocated)."""
    rcfg = ref_get_config(arch)
    tree = jax.eval_shape(lambda k: RT.init_params(k, rcfg), jax.random.PRNGKey(0))
    with FakeTensorMode():
        model = PT.Transformer(get_config(arch), device="cpu")
        got = PT.param_count(model)
    assert got == RT.param_count(tree)
    if arch == "deepseek-7b":
        assert got == 6_910_365_696


@pytest.mark.parametrize("codebooks", [0, 3])
def test_cross_entropy_matches_reference(codebooks):
    """Mean over every leading axis (codebooks too), with padded vocab
    slots at -1e30: within 4 ulp32 of the loss."""
    rng = np.random.RandomState(codebooks)
    shape = (2, 5, codebooks, 40) if codebooks else (2, 5, 40)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    logits[..., 37:] = -1e30
    labels = rng.randint(0, 37, shape[:-1]).astype(np.int32)
    want = float(RT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(PT.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 4 * np.spacing(np.float32(want))


ATTENTION = ["deepseek-7b", "stablelm-12b", "granite-moe-1b-a400m", "minicpm3-4b"]


@pytest.mark.parametrize("arch", ATTENTION)
def test_loss_gradients_and_train_step_match_reference(arch):
    """``loss_fn`` and every gradient leaf on microbatch 0, then one
    ``make_train_step`` over 2 microbatches: loss, gradient norm, first
    moment, parameters (sign-undetermined updates under 1%)."""
    check_train_parity(arch, ref_train_run(arch))


def test_moe_aux_loss_matches_reference():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    rcfg = ref_get_config("granite-moe-1b-a400m").reduced()
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((3, 8, cfg.n_experts)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[..., :cfg.top_k].astype(np.int32)
    want = float(RL.moe_aux_loss(rcfg, jnp.asarray(probs), jnp.asarray(idx)))
    got = float(PL.moe_aux_loss(cfg, torch.from_numpy(probs), torch.from_numpy(idx)))
    assert abs(got - want) <= 4 * np.spacing(np.float32(want))


@pytest.mark.parametrize("arch,group", [("deepseek-7b", 1), ("deepseek-7b", 2),
                                        ("zamba2-1.2b", 1), ("xlstm-1.3b", 1)])
def test_remat_gradients_equal_plain(arch, group):
    """Checkpointed blocks (per block, or per group of ``remat_group``)
    recompute the same forward: gradients equal the plain pass bit for
    bit, and the loss does not change."""
    _, cfg, _, model = train_pair(arch, n=1)
    batch = torch_batch(train_batch(cfg, 1, seed=2))
    plain = loss_and_grads(dataclasses.replace(cfg, remat=False), model, batch)
    remat = loss_and_grads(dataclasses.replace(cfg, remat=True, remat_group=group), model,
                           batch)
    assert torch.equal(plain[0], remat[0])
    for k, g in plain[1].items():
        assert torch.equal(g, remat[1][k]), k


def test_microbatch_gradients_accumulate_in_float32():
    """A bf16 model: the accumulated gradient is each microbatch's
    gradient cast to float32, summed in order and divided by N, not a
    bf16 ``.grad`` sum."""
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(), dtype="bfloat16",
                              train_microbatches=2)
    model = PT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = torch_batch(train_batch(cfg, 2, seed=3))
    got, loss = accumulated_grads(cfg, model, batch, 2)
    parts = [loss_and_grads(cfg, model, {k: v[i] for k, v in batch.items()}) for i in range(2)]
    assert torch.equal(loss, (parts[0][0] + parts[1][0]) / 2)
    for k, g in got.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, (parts[0][1][k].float() + parts[1][1][k].float()) / 2), k


def test_train_step_refuses_sharded_accumulation():
    """Sharded accumulation is ported: a ``{name: NamedSharding}`` mapping
    (``build_cell``'s moment layout) gives the ZeRO step (run over gloo
    ranks in ``tests/test_torch_distributed.py``); anything else is refused."""
    from repro_torch.launch.steps import abstract_state
    from repro_torch.parallel.sharding import params_sharding

    cfg = get_config("deepseek-7b").reduced()
    with pytest.raises(TypeError, match="accum_shardings"):
        make_train_step(cfg, accum_shardings=object())
    _, opt = abstract_state(cfg)
    mu = params_sharding(opt, {"data": 1, "model": 1}, fsdp=True)["mu"]
    assert callable(make_train_step(cfg, accum_shardings=mu))


def test_loss_fn_is_the_uncached_forward_cross_entropy():
    """``loss_fn`` equals ``cross_entropy`` of the no-grad forward's logits,
    adds no MoE auxiliary loss, and leaves the parameters frozen."""
    _, cfg, _, model = train_pair("granite-moe-1b-a400m", n=1)
    batch = torch_batch(train_batch(cfg, 1, seed=4))
    logits, _ = PT.forward(cfg, model, batch)
    want = PT.cross_entropy(logits, batch["labels"])
    assert torch.equal(PT.loss_fn(cfg, model, batch), want)
    assert not any(p.requires_grad for p in model.parameters())
    make_train_step(cfg)(model, adamw_init(model), batch)
    assert not any(p.requires_grad for p in model.parameters())
