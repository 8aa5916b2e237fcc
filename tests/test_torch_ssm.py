"""The port's SSM and hybrid models against the reference's, on the CPU.

Function by function (``repro_torch.models.ssm`` against
``repro.models.ssm``) at ``reduced()`` widths of zamba2-1.2b (d 64,
d_inner 128 = 8 heads of 16, ds 16, chunk 16) and xlstm-1.3b (4 heads of
32, chunk 16), float32, on the same numpy inputs from a seed and the
reference's own ``init_*`` parameters: the Mamba2 chunked form with S no
multiple of the chunk, the causal conv with and without carried context,
the recurrent steps, the mLSTM chunked form with a padded tail, sLSTM
with and without a starting state, and the three ``init_*_cache``
functions. Then the model: the scan op the card runs (``ssm_scan``, whose
CPU path is the kernel's chunked plain version) on the model's own scan
inputs against the reference's chunk body; ``prefill``'s ``None`` entries
where the reference's are; the ``Server`` against the reference's; the
state-dict conversion of the three heterogeneous parameter trees; the
init distribution of the new leaves; the full-width configs' shapes.

Tolerance: ``rtol 1e-4, atol 1e-5`` (``torch_parity.LM_F32_TOL``), the
atol in units of the compared output's rms where that exceeds one
(:func:`close`). The same float32 arithmetic summed in another order
differs by ~1e-6 at unit scale. The mLSTM's outputs have an rms of
2.3-4.0 on these inputs, and its exponential input gates amplify the
in-projection's rounding: the CPU's float32 GEMM (MKL) has an rms error
of 1.4e-7 against float64 at K 64 where XLA's dot has 8.2e-8, so over
eight seeds the port's ``mlstm_chunked`` lands 1.2e-5 to 1.1e-4 from a
float64 run of the same function and the reference's 1.1e-5 to 6.0e-5
(with the projection in float64 the port's falls to 9e-6 to 1.8e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.runtime import server as RSV
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import kernel as SK
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.runtime import server as PSV
from torch_parity import LM_F32_TOL, lm_port_model, synced_ref_server

B = 2
ref_init_params = jax.jit(RT.init_params, static_argnums=1)


def cfgs(arch, **kw):
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def close(got, want, what=""):
    """Within ``LM_F32_TOL``, its atol times the rms of ``want`` where
    that exceeds one."""
    want = np.asarray(want)
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want.astype(np.float64))))))
    np.testing.assert_allclose(np.asarray(got), want, rtol=LM_F32_TOL["rtol"],
                               atol=LM_F32_TOL["atol"] * scale, err_msg=what)


def rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def mixer_pair(kind, arch):
    """The reference's ``init_<kind>`` parameters and the port's mixer
    module holding the same values."""
    rcfg, cfg = cfgs(arch)
    init = {"mamba": RS.init_mamba, "mlstm": RS.init_mlstm, "slstm": RS.init_slstm}[kind]
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), rcfg))
    cls = {"mamba": PS.Mamba2, "mlstm": PS.MLSTM, "slstm": PS.SLSTM}[kind]
    module = cls(cfg, device="cpu", dtype=torch.float32)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return rcfg, cfg, params, module


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [37, 16, 5], ids=["ragged", "one-chunk", "short"])
def test_mamba_chunked_matches_reference(S):
    rcfg, cfg, params, module = mixer_pair("mamba", "zamba2-1.2b")
    x = rand((B, S, cfg.d_model), S)
    want = RS.mamba_chunked(rcfg, params, jnp.asarray(x), chunk=cfg.scan_chunk)
    close(PS.mamba_chunked(cfg, module, t(x), chunk=cfg.scan_chunk), want)


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv_matches_reference(S, with_state):
    K, C = 4, 24
    x, w, b = rand((B, S, C), 1), rand((K, C), 2, 0.5), rand((C,), 3)
    state = rand((B, K - 1, C), 4) if with_state else None
    want = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           None if state is None else jnp.asarray(state))
    got = PS._causal_conv(t(x), t(w), t(b), None if state is None else t(state))
    close(got[0], want[0], "out")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_segsum_matches_reference():
    dA = -np.abs(rand((3, 2, 16), 5))
    want = np.asarray(RS._segsum(jnp.asarray(dA)))
    got = PS._segsum(t(dA)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin])


def test_mamba_step_matches_reference():
    rcfg, cfg, params, module = mixer_pair("mamba", "zamba2-1.2b")
    cache = {k: v + rand(v.shape, 6) for k, v in
             jax.tree.map(np.asarray, RS.init_mamba_cache(rcfg, B)).items()}
    x = rand((B, 1, cfg.d_model), 7)
    want_out, want_cache = RS.mamba_step(rcfg, params, jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, cache))
    got_out, got_cache = PS.mamba_step(cfg, module, t(x), {k: t(v) for k, v in cache.items()})
    close(got_out, want_out)
    assert set(got_cache) == set(want_cache) == {"h", "conv"}
    for k in want_cache:
        close(got_cache[k], want_cache[k], k)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [37, 32], ids=["padded-tail", "whole-chunks"])
def test_mlstm_chunked_matches_reference(S):
    rcfg, cfg, params, module = mixer_pair("mlstm", "xlstm-1.3b")
    x = rand((B, S, cfg.d_model), S)
    want = RS.mlstm_chunked(rcfg, params, jnp.asarray(x), chunk=cfg.scan_chunk)
    close(PS.mlstm_chunked(cfg, module, t(x), chunk=cfg.scan_chunk), want)


def test_mlstm_step_matches_reference():
    rcfg, cfg, params, module = mixer_pair("mlstm", "xlstm-1.3b")
    cache = {k: v + rand(v.shape, 8, 0.3) for k, v in
             jax.tree.map(np.asarray, RS.init_mlstm_cache(rcfg, B)).items()}
    x = rand((B, 1, cfg.d_model), 9)
    want_out, want_cache = RS.mlstm_step(rcfg, params, jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, cache))
    got_out, got_cache = PS.mlstm_step(cfg, module, t(x), {k: t(v) for k, v in cache.items()})
    close(got_out, want_out)
    assert set(got_cache) == set(want_cache) == {"C", "n"}
    for k in want_cache:
        close(got_cache[k], want_cache[k], k)


@pytest.mark.parametrize("S", [9, 1])
@pytest.mark.parametrize("with_cache", [False, True], ids=["fresh", "cache"])
def test_slstm_forward_matches_reference(with_cache, S):
    rcfg, cfg, params, module = mixer_pair("slstm", "xlstm-1.3b")
    cache = None
    if with_cache:
        z = np.zeros((B, cfg.d_inner), np.float32)
        cache = {"c": rand(z.shape, 10), "n": 1 + np.abs(rand(z.shape, 11)),
                 "h": rand(z.shape, 12, 0.5), "m": rand(z.shape, 13)}
    x = rand((B, S, cfg.d_model), 14)
    want_out, want_state = RS.slstm_forward(
        rcfg, params, jnp.asarray(x), None if cache is None else jax.tree.map(jnp.asarray, cache))
    got_out, got_state = PS.slstm_forward(
        cfg, module, t(x), None if cache is None else {k: t(v) for k, v in cache.items()})
    close(got_out, want_out)
    assert set(got_state) == set(want_state) == {"c", "n", "h", "m"}
    for k in want_state:
        close(got_state[k], want_state[k], k)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_caches_equal_the_reference(kind):
    arch = "zamba2-1.2b" if kind == "mamba" else "xlstm-1.3b"
    rcfg, cfg = cfgs(arch)
    if kind == "mamba":
        want = RS.init_mamba_cache(rcfg, B, dtype=jnp.bfloat16)
        got = PS.init_mamba_cache(cfg, B, dtype=torch.bfloat16, device="cpu")
    else:
        want = getattr(RS, f"init_{kind}_cache")(rcfg, B)
        got = getattr(PS, f"init_{kind}_cache")(cfg, B, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and str(got[k].dtype)[6:] == str(w.dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# The scan op on the model's scan inputs
# ---------------------------------------------------------------------------


def captured_scan_inputs(cfg, module, x):
    """The (x, B, C, dA, dt, chunk) that ``mamba_chunked`` hands
    ``mamba_scan``, and its output."""
    seen = []
    scan = PS.mamba_scan

    def record(*args):
        seen.append(args)
        return scan(*args)

    PS.mamba_scan = record
    try:
        out = PS.mamba_chunked(cfg, module, x, chunk=cfg.scan_chunk)
    finally:
        PS.mamba_scan = scan
    assert len(seen) == 1
    return seen[0], out


@pytest.mark.parametrize("S", [37, 64])
def test_scan_op_computes_the_models_scan(S, monkeypatch):
    """``ssm_scan`` (what CUDA tensors launch; its CPU path the kernel's
    chunked plain version) on the model's own x, B, C, dA, dt, cast to
    float32 as the card path casts them: equal to the reference's chunk
    body (the port's copy, ``mamba_scan_plain``) within the tolerance,
    and the whole mixer with it in place of the body within the same
    tolerance of the reference's ``mamba_chunked``."""
    rcfg, cfg, params, module = mixer_pair("mamba", "zamba2-1.2b")
    x = rand((B, S, cfg.d_model), 20 + S)
    (xs, bm, cm, dA, dt, chunk), out = captured_scan_inputs(cfg, module, t(x))
    assert xs.dtype == bm.dtype == cm.dtype == torch.float32 and dA.dtype == dt.dtype
    op = ssm_scan(xs.float(), bm.float(), cm.float(), dA, dt, chunk=chunk)
    assert op.dtype == torch.float32 and op.shape == xs.shape
    close(op, PS.mamba_scan_plain(xs, bm, cm, dA, dt, chunk))
    monkeypatch.setattr(PS, "mamba_scan", lambda x_, b_, c_, a_, d_, ck: ssm_scan(
        x_.float(), b_.float(), c_.float(), a_, d_, chunk=ck))
    want = RS.mamba_chunked(rcfg, params, jnp.asarray(x), chunk=cfg.scan_chunk)
    close(PS.mamba_chunked(cfg, module, t(x), chunk=cfg.scan_chunk), want)
    close(out, want)


def test_scan_on_other_devices_takes_the_kernel_or_raises():
    """Only CPU tensors run the chunk body: any other device goes to the
    kernel's wrapper, which refuses data it cannot launch on (no
    fallback). ``meta`` tensors, which hold no data, take the wrapper too
    and get its empty output (the dry run's trace), launching nothing."""
    x = torch.zeros((1, 8, 2, 4), device="meta")
    bc, a = torch.zeros((1, 8, 4), device="meta"), torch.zeros((1, 8, 2), device="meta")
    SK.reset_launch_count()
    y = PS.mamba_scan(x, bc, bc, a, a, 4)
    assert y.device.type == "meta" and y.shape == x.shape and y.dtype == torch.float32
    assert SK.SSD_LAUNCHES == 0
    xc, bcc, ac = (torch.zeros(t.shape) for t in (x, bc, a))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        SK.ssm_scan_kernel(xc.transpose(1, 2).reshape(2, 8, 4).contiguous(), bcc, bcc,
                           ac.transpose(1, 2).reshape(2, 8).contiguous(),
                           ac.transpose(1, 2).reshape(2, 8).contiguous(), chunk=4)


def test_cpu_model_launches_no_ssd_kernel():
    _, cfg = cfgs("zamba2-1.2b")
    SK.reset_launch_count()
    model = PT.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    PT.forward(cfg, model, {"tokens": torch.zeros((1, 20), dtype=torch.long)})
    assert SK.SSD_LAUNCHES == 0


# ---------------------------------------------------------------------------
# The model: prefill's states, the Server, conversion, init, full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_prefill_drops_the_states_the_reference_drops(arch):
    """``prefill`` returns ``None`` at every Mamba2 and mLSTM position,
    exactly where the reference's does, and attention caches and sLSTM
    states elsewhere, with the reference's values; decoding from that
    cache raises ``TypeError`` on both sides."""
    rcfg, cfg = cfgs(arch)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    model = lm_port_model(cfg, params)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (B, 10)).astype(np.int32)
    _, want = RT.prefill(rcfg, params, {"tokens": jnp.asarray(toks)},
                         RT.init_cache(rcfg, B, 16))
    _, got = PT.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                        PT.init_cache(cfg, B, 16, device="cpu"))
    assert [c is None for c in got] == [c is None for c in want] == \
        [k in ("mamba", "mlstm") for k in cfg.pattern]
    for g, w in zip(got, want):
        if w is not None:
            assert set(g) == set(w)
            for k in w:
                close(g[k], w[k], k)
    step = {"tokens": toks[:, :1], "cur_index": 10}
    with pytest.raises(TypeError):
        RT.serve_step(rcfg, params, {k: jnp.asarray(v) for k, v in step.items()}, want)
    with pytest.raises(TypeError):
        PT.serve_step(cfg, model, {"tokens": torch.from_numpy(toks[:, :1]),
                                   "cur_index": 10}, got)


SERVER_PROMPTS = {0: [3, 9, 4], 1: [11, 5, 7, 2, 60, 1, 8], 2: [21, 9, 14, 2]}


def serve_both(arch, requests, slots=2):
    rcfg, cfg = cfgs(arch)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ref = synced_ref_server()(rcfg, params, slots=slots, max_seq=32)
    port = PSV.Server(cfg, lm_port_model(cfg, params), slots=slots, max_seq=32)
    out = []
    for srv, mod in ((ref, RSV), (port, PSV)):
        for rid, prompt, max_new in requests:
            srv.submit(mod.Request(rid, np.array(prompt, np.int32), max_new_tokens=max_new))
        out.append(dict(srv.run_until_drained()))
    return out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_server_tokens_equal_the_reference_servers(arch):
    """Three requests on 2 slots, the third admitted mid-decode: the
    port's ``Server`` emits the reference ``Server``'s tokens (its slots
    share the recurrent blocks' behaviour: an idle slot still steps its
    state)."""
    ref, port = serve_both(arch, [(rid, p, 5) for rid, p in SERVER_PROMPTS.items()])
    assert port == ref and sorted(port) == sorted(SERVER_PROMPTS)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_server_slots_are_not_isolated_on_recurrent_blocks(arch):
    """The reference's recurrent steps ignore positions, so a slot idle at
    -1 still advances its state with token 0: a request served beside
    another gives other tokens than served alone. The port reproduces
    both runs token for token, the difference included."""
    prompt = (0, SERVER_PROMPTS[1], 8)
    ref_alone, port_alone = serve_both(arch, [prompt])
    ref_pair, port_pair = serve_both(arch, [prompt, (1, SERVER_PROMPTS[0], 8)])
    assert port_alone == ref_alone and port_pair == ref_pair
    assert ref_alone[0] != ref_pair[0]


def is_shared(cfg):
    return cfg.shared_attn and "attn" in cfg.pattern


HETEROGENEOUS = {"zamba2-1.2b": {}, "xlstm-1.3b": {},
                 "zamba2-unshared-attn": {"shared_attn": False}}


@pytest.mark.parametrize("name", sorted(HETEROGENEOUS))
def test_state_dict_conversion_is_complete(name):
    """Every entry of the port's state dict, and no other, comes from the
    reference's tree, with its shape and type: ``blocks.<kind>.<i>`` per
    stack, ``blocks.attn_shared`` once."""
    arch = name if name in ("zamba2-1.2b", "xlstm-1.3b") else "zamba2-1.2b"
    rcfg, cfg = cfgs(arch, **HETEROGENEOUS[name])
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg))
    assert ("attn_shared" in tree["blocks"]) == is_shared(cfg)
    sd = convert.lm_params_from_reference(cfg, tree)
    model = PT.Transformer(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    n_leaves = sum(a.shape[0] if kind != "attn_shared" else 1
                   for kind, sub in tree["blocks"].items() for a in jax.tree.leaves(sub))
    assert len([k for k in sd if k.startswith("blocks.")]) == n_leaves


def test_conversion_refuses_a_stack_of_the_wrong_depth():
    rcfg, cfg = cfgs("xlstm-1.3b")
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg))
    tree["blocks"]["mlstm"] = jax.tree.map(lambda a: a[:1], tree["blocks"]["mlstm"])
    with pytest.raises(ValueError, match="1 layers, config has 2"):
        convert.lm_params_from_reference(cfg, tree)


def test_init_params_follows_the_reference_distribution():
    """The new leaves as the reference draws them: projections normal /
    sqrt(fan_in), Mamba2's conv normal * 0.5 with a zero bias, A_log =
    log(linspace(1, 16, nh)), D one, dt_bias zero; mLSTM's f_bias 3;
    sLSTM's r normal / sqrt(ph); the float32 leaves float32 in a bf16
    model; the shared block one set of weights."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), d_model=256, dtype="bfloat16")
    gen = torch.Generator().manual_seed(3)
    model = PT.init_params(cfg, generator=gen, device="cpu")
    mixer = model.blocks["mamba"][0].mixer
    d, di = cfg.d_model, cfg.d_inner
    for w, want in ((mixer.in_proj, d ** -0.5), (mixer.conv_w, 0.5), (mixer.out_proj, di ** -0.5)):
        assert w.dtype == torch.bfloat16
        assert abs(float(w.float().std()) / want - 1) < 0.05
    nh = di // cfg.ssm_head_dim
    for leaf in ("A_log", "D", "dt_bias"):
        assert getattr(mixer, leaf).dtype == torch.float32
    rcfg = dataclasses.replace(ref_get_config("zamba2-1.2b").reduced(), d_model=256,
                               dtype="bfloat16")
    ref_leaves = jax.tree.map(np.asarray, RS.init_mamba(jax.random.PRNGKey(0), rcfg))
    for leaf in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(getattr(mixer, leaf).float().numpy(),
                                   ref_leaves[leaf].astype(np.float32), rtol=1e-6, err_msg=leaf)
    assert mixer.A_log.shape == (nh,)
    assert list(dict(model.blocks.named_children())) == ["mamba", "attn_shared"]

    xcfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), d_model=256,
                               dtype="bfloat16")
    xmodel = PT.init_params(xcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    ml, sl = xmodel.blocks["mlstm"][0].mixer, xmodel.blocks["slstm"][0].mixer
    ph = xcfg.d_inner // xcfg.n_heads
    assert ml.f_bias.dtype == torch.float32 and torch.equal(ml.f_bias, torch.full((4,), 3.0))
    assert sl.r.dtype == torch.float32 and sl.r.shape == (xcfg.n_heads, ph, 4 * ph)
    for w, want in ((ml.in_proj, 256 ** -0.5), (sl.w_in, 256 ** -0.5),
                    (sl.r, ph ** -0.5), (sl.out_proj, xcfg.d_inner ** -0.5)):
        assert abs(float(w.float().std()) / want - 1) < 0.05
    again = PT.init_params(xcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again.blocks["slstm"][1].mixer.r, xmodel.blocks["slstm"][1].mixer.r)


def reference_state_shapes(cfg, tree) -> dict:
    """The port's state-dict names for a block pattern's parameter tree,
    with shapes and type names."""
    out = {"embed.table": (tree["embed"]["table"].shape, str(tree["embed"]["table"].dtype)),
           "final_norm.scale": (tree["final_norm"]["scale"].shape,
                                str(tree["final_norm"]["scale"].dtype))}
    if "w" in tree["lm_head"]:
        out["lm_head.w"] = (tree["lm_head"]["w"].shape, str(tree["lm_head"]["w"].dtype))
    for kind, sub in tree["blocks"].items():
        for path, s in convert._leaves(sub):
            if kind == "attn_shared":
                out[f"blocks.{kind}.{path}"] = (s.shape, str(s.dtype))
            else:
                for i in range(cfg.pattern.count(kind)):
                    out[f"blocks.{kind}.{i}.{path}"] = (s.shape[1:], str(s.dtype))
    return out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_full_width_config_builds_with_the_reference_shapes(arch):
    """Every weight and every per-layer cache entry of the full-width
    config has the reference's shape and type (``jax.eval_shape``
    against a build under ``FakeTensorMode``): zamba2 33 Mamba2 stacks of
    64 heads of 64 and one shared block with 5 attention caches; xlstm 42
    mLSTM and 6 sLSTM."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    tree = jax.eval_shape(lambda k: RT.init_params(k, rcfg), jax.random.PRNGKey(0))
    rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, 2, 1040))
    with FakeTensorMode():
        model = PT.Transformer(cfg, device="cpu")
        got = {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in model.state_dict().items()}
        cache = [{k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in c.items()}
                 for c in PT.init_cache(cfg, 2, 1040, device="cpu")]
    assert got == {k: (tuple(s), d) for k, (s, d) in reference_state_shapes(rcfg, tree).items()}
    assert cache == [{k: (v.shape, str(v.dtype)) for k, v in c.items()} for c in rcache]
    counts = {k: cfg.pattern.count(k) for k in dict.fromkeys(cfg.pattern)}
    assert counts == ({"mamba": 33, "attn": 5} if arch == "zamba2-1.2b"
                      else {"mlstm": 42, "slstm": 6})
    if arch == "zamba2-1.2b":
        assert (cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state,
                cfg.scan_chunk) == (64, 64, 64, 128)
        assert (cfg.scan_chunk <= SK.MAX_CHUNK and cfg.ssm_head_dim <= SK.MAX_PH
                and cfg.ssm_state <= SK.MAX_DS)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_reduced_patterns_are_the_references(arch):
    _, cfg = cfgs(arch)
    assert cfg.pattern == {"zamba2-1.2b": ("mamba", "attn", "mamba", "attn"),
                           "xlstm-1.3b": ("mlstm", "slstm", "mlstm", "slstm")}[arch]
    assert cfg.pattern == ref_get_config(arch).reduced().pattern
