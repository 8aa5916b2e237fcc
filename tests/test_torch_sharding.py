"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``), spec for spec.

* The reference's own cases (``tests/test_sharding_rules.py``), as
  parametrised cases.
* Every parameter and AdamW moment leaf of all ten configs at full size,
  on both production meshes (16 x 16 ``(data, model)``, 2 x 16 x 16
  ``(pod, data, model)``), ``fsdp`` on and off: the port's leaves from
  ``launch.steps.abstract_state`` (built under ``FakeTensorMode``), the
  reference's from ``jax.eval_shape``, its meshes ``AbstractMesh``es (no
  devices). Each port leaf's spec is the reference's stacked spec with
  the layer dim dropped, and no rule shards a layer dim.
* ``cache_sharding`` on every decode shape, ``input_sharding`` and
  ``batch_sharding`` on every applicable shape.

No process group is needed: a mesh is ``{axis: size}``."""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES, applicable_shapes
from repro.configs import cache_specs as ref_cache_specs
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.launch.steps import abstract_state as ref_abstract_state
from repro.parallel import sharding as RS
from repro_torch.configs import SHAPES, cache_specs, get_config, input_specs
from repro_torch.launch.steps import abstract_state
from repro_torch.parallel import sharding as PS
from torch_parity import one_torch_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def ref_flat(tree) -> dict:
    """{reference path: leaf} of a pytree (``_path_str``'s paths)."""
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: out.__setitem__(RS._path_str(p), x), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return out


def port_flat(tree, sep=".") -> dict:
    out = {}
    PS.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree, sep=sep)
    return out


def spec_of(sharding, ndim: int) -> tuple:
    """A reference sharding's spec, padded with ``None`` to ``ndim``."""
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def ref_state(arch):
    return ref_abstract_state(ref_get_config(arch), with_opt=True)


@functools.lru_cache(maxsize=None)
def port_state(arch):
    return abstract_state(get_config(arch), with_opt=True)


# --------------------------------------------------------------------------
# the reference's own cases
# --------------------------------------------------------------------------

REF_CASES = [
    ("blocks/ff/w_in", (80, 8192, 29568), (None, None, "model")),
    ("blocks/ff/w_out", (80, 29568, 8192), (None, "model", None)),
    ("blocks/ff/w_in", (94, 128, 4096, 1536), (None, "model", None, None)),
    ("blocks/attn/wq", (30, 4096, 32, 128), (None, None, "model", None)),
    ("blocks/attn/wk", (88, 6144, 1, 128), (None, None, None, "model")),
    ("blocks/attn/q_up", (62, 768, 40, 96), (None, "model", None, None)),
    ("blocks/norm1/scale", (30, 4096), (None, None)),
    ("blocks/ff/router", (24, 1024, 32), (None, None, None)),
    ("embed/table", (49155, 1024), (None, "model")),
    ("lm_head/w", (4096, 151936), (None, "model")),
    ("blocks/attn/wo", (30, 4096, 4096), (None, "model", None)),
]


@pytest.mark.parametrize("path,shape,want", REF_CASES, ids=[f"{c[0]}-{len(c[1])}d" for c in REF_CASES])
def test_param_spec_reference_cases(path, shape, want):
    got = PS.param_spec(path, shape, "model", 16)
    assert got == want
    assert got == tuple(RS.param_spec(path, shape, "model", 16))


CACHE_LAYOUTS = {
    "gqa": dict(),
    "int8": dict(kv_cache_dtype="int8"),
    "mla": dict(use_mla=True, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16),
}


@pytest.mark.parametrize("layout", sorted(CACHE_LAYOUTS))
def test_cache_sharding_handles_every_layout(layout):
    """The reference's layout cases (plain GQA, int8, MLA) on a 1 x 1 mesh,
    and on the 16 x 16 mesh, spec for spec."""
    from repro.models.config import ModelConfig as RefConfig
    from repro.models.transformer import init_cache as ref_init_cache
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import init_cache

    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
              head_dim=16, dtype="float32", **CACHE_LAYOUTS[layout])
    rcfg, cfg = RefConfig("t", "dense", **kw), ModelConfig("t", "dense", **kw)
    rcache = jax.eval_shape(lambda: ref_init_cache(rcfg, 4, 32))
    cache = init_cache(cfg, 4, 32, device="cpu")
    for shape, axes in (((1, 1), ("data", "model")), MESHES["16x16"]):
        want = ref_flat(RS.cache_sharding(rcfg, rcache, AbstractMesh(shape, axes), 4))
        got = port_flat(PS.cache_sharding(cfg, cache, dict(zip(axes, shape)), 4), sep="/")
        assert got.keys() == want.keys()
        for k, s in got.items():
            assert s.spec == spec_of(want[k], cache[k].dim()), k


# --------------------------------------------------------------------------
# every leaf of every config at full size
# --------------------------------------------------------------------------


def assert_tree_specs(port_tree, ref_tree, ref_shardings, port_shardings):
    """Every port leaf's spec == its reference leaf's stacked spec with the
    layer dim (None there) dropped; every reference leaf is reached."""
    want, ref_leaves = ref_flat(ref_shardings), ref_flat(ref_tree)
    got, leaves = port_flat(port_shardings), port_flat(port_tree)
    depths = PS.stack_depths(leaves)
    reached = set()
    for name, s in got.items():
        path, shape, stacked = PS.reference_leaf(name, tuple(leaves[name].shape), depths)
        assert tuple(ref_leaves[path].shape) == shape, name
        spec = spec_of(want[path], len(shape))
        if stacked:
            assert spec[0] is None, (path, spec)  # no rule shards the layer dim
            spec = spec[1:]
        assert s.spec == spec, (name, s.spec, spec)
        reached.add(path)
    assert reached == set(want)


@pytest.mark.parametrize("fsdp", [False, True], ids=["fsdp-off", "fsdp-on"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_moments_equal_the_reference(arch, mesh, fsdp):
    amesh, pmesh = meshes(mesh)
    (rparams, ropt), (params, opt) = ref_state(arch), port_state(arch)
    assert_tree_specs(params, rparams, RS.params_sharding(rparams, amesh, fsdp=fsdp),
                      PS.params_sharding(params, pmesh, fsdp=fsdp))
    assert_tree_specs(opt, ropt, RS.params_sharding(ropt, amesh, fsdp=fsdp),
                      PS.params_sharding(opt, pmesh, fsdp=fsdp))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh):
    """``cache_sharding`` on every decode shape of the config."""
    amesh, pmesh = meshes(mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    decode = [s for s in applicable_shapes(arch) if SHAPES[s].kind == "decode"]
    assert decode
    for name in decode:
        B = SHAPES[name].global_batch
        rcache, cache = ref_cache_specs(rcfg, REF_SHAPES[name]), cache_specs(cfg, name)
        want = ref_flat(RS.cache_sharding(rcfg, rcache, amesh, B))
        leaves = port_flat(cache, sep="/")
        got = port_flat(PS.cache_sharding(cfg, cache, pmesh, B), sep="/")
        assert got.keys() == want.keys()
        for k, s in got.items():
            assert s.spec == spec_of(want[k], leaves[k].dim()), (name, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_batch_specs_equal_the_reference(arch, mesh):
    """``input_sharding`` on every applicable shape (the microbatched
    layout at this mesh's DP width), and ``batch_sharding`` on each
    shape's (B, S) and (B, S, d) with and without a sequence dim."""
    amesh, pmesh = meshes(mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    dp = 32 if mesh == "2x16x16" else 16
    for name in applicable_shapes(arch):
        rin = ref_input_specs(rcfg, name, dp_size=dp)
        pin = input_specs(cfg, name, dp_size=dp)
        want = RS.input_sharding(rcfg, amesh, rin)
        got = PS.input_sharding(cfg, pmesh, pin)
        assert got.keys() == want.keys()
        for k, s in got.items():
            assert s.spec == spec_of(want[k], pin[k].dim()), (name, k)
        shape = SHAPES[name]
        for ndim, seq_dim in ((2, 1), (2, None), (3, 1)):
            w = RS.batch_sharding(amesh, shape.global_batch, ndim, seq_dim, shape.seq_len)
            g = PS.batch_sharding(pmesh, shape.global_batch, ndim, seq_dim, shape.seq_len)
            assert g.spec == spec_of(w, ndim), (name, ndim, seq_dim)


def test_dp_axes_and_replicated():
    for name in MESHES:
        amesh, pmesh = meshes(name)
        assert PS.dp_axes(pmesh) == RS.dp_axes(amesh)
        assert PS.replicated(pmesh).spec == tuple(RS.replicated(amesh).spec) == ()


# --------------------------------------------------------------------------
# specs to DTensor placements
# --------------------------------------------------------------------------


def test_a_spec_becomes_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    assert PS.to_placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert PS.to_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert PS.to_placements((), mesh) == (Replicate(),) * 3
    assert PS.NamedSharding({"data": 16, "model": 16}, ("data", "model")).placements == \
        (Shard(0), Shard(1))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        PS.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="shards dims"):
        PS.to_placements(("model", "model"), mesh)


def test_the_layer_dim_of_a_stack_is_never_sharded():
    """A rule that would shard a stacked leaf's layer dim raises rather
    than drop it: (L, d) norms at a size the ZeRO rule takes, with d not
    divisible by the DP width, fall through to the layer dim."""
    import torch

    params = {f"blocks.{i}.norm1.scale": torch.empty(1_048_575, device="meta")
              for i in range(32)}
    with pytest.raises(ValueError, match="layer dim"):
        PS.params_sharding(params, {"data": 16, "model": 16}, fsdp=True)
    np.testing.assert_equal(RS.params_sharding(
        {"blocks": {"norm1": {"scale": jax.ShapeDtypeStruct((32, 1_048_575), np.float32)}}},
        AbstractMesh((16, 16), ("data", "model")), fsdp=True)["blocks"]["norm1"]["scale"]
        .spec[0], "data")
