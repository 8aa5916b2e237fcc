"""The port's CNNs against the reference, on the CPU.

``repro_torch.models`` (``cnn_common``, ``MobileNetV2``, ``ResNet50``) is
held to ``repro.models`` on the reference's own parameters, carried over
with ``convert.cnn_params_from_reference``, and on inputs drawn from a
numpy seed. The port's convolutions (oneDNN) sum in another order than
XLA's, so every comparison is max |diff| <= TOL x rms(ref), and top-1
classes must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn_common as RC
from repro.models.mobilenetv2 import MobileNetV2 as RefMobileNetV2
from repro.models.resnet50 import ResNet50 as RefResNet50
from repro_torch.convert import cnn_params_from_reference
from repro_torch.device import _float32_knobs
from repro_torch.models import cnn_common as PC
from repro_torch.models.graph import mobilenet_v2_graph, resnet50_graph
from repro_torch.models.mobilenetv2 import MobileNetV2
from repro_torch.models.resnet50 import ResNet50

# float32 sums in another order: the probes gave 4e-6..8e-6 x rms on
# whole models, so this leaves an order of magnitude
TOL = 1e-4

MODELS = {
    "mobilenet_v2": (RefMobileNetV2, MobileNetV2, dict(width=0.35, image_size=64), 2),
    "resnet50": (RefResNet50, ResNet50, dict(image_size=64), 1),
}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.sqrt((want ** 2).mean()))


def assert_close(got, want, tol=TOL):
    assert rel_err(got, want) <= tol


def normal(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def chain(request):
    """Each model at a small size on the reference's parameters: the
    reference's carry before and after every layer, run layer by layer."""
    Ref, Port, kw, batch = MODELS[request.param]
    ref, port = Ref(**kw), Port(**kw)
    rparams = to_np(ref.init(jax.random.PRNGKey(0)))
    x = normal(ref.input_shape(batch), seed=1)
    carries = [jnp.asarray(x)]
    for name in ref.layer_names:
        carries.append(ref.apply_layer(name, rparams[name], carries[-1]))
    return {"name": request.param, "ref": ref, "port": port, "rparams": rparams,
            "params": cnn_params_from_reference(rparams), "x": x,
            "carries": [carries[0]] + [to_np(c) for c in carries[1:]]}


def test_layer_names_match_reference_and_graph(chain):
    graph = (mobilenet_v2_graph(width=0.35, image_size=64) if chain["name"] == "mobilenet_v2"
             else resnet50_graph(image_size=64))
    names = chain["port"].layer_names
    assert names == chain["ref"].layer_names == [n.name for n in graph.nodes]
    assert len(names) == {"mobilenet_v2": 54, "resnet50": 52}[chain["name"]]


KINDS = {"mobilenet_v2": ("conv", "expand", "dw", "project", "pool", "dense"),
         "resnet50": ("conv", "maxpool", "b1", "b2", "b3", "pool", "dense")}


@pytest.mark.parametrize("chain,kind", [(m, k) for m in sorted(KINDS) for k in KINDS[m]],
                         indirect=["chain"])
def test_every_layer_of_a_kind_matches_reference(chain, kind):
    """Each layer of ``kind`` on the reference's own input carry: every
    leaf of the port's output carry within TOL x rms of the reference's."""
    port, carries = chain["port"], chain["carries"]
    names = [n for n, k, _ in port._specs if k == kind]
    assert names
    for name in names:
        i = port.layer_names.index(name)
        got = port.apply_layer(name, chain["params"][name], to_torch(carries[i]))
        want = carries[i + 1]
        assert sorted(got) == sorted(want), name
        for leaf in want:
            assert got[leaf].dtype == torch.float32
            assert_close(got[leaf].numpy(), want[leaf])


def test_whole_model_matches_reference(chain):
    port = chain["port"]
    carry = torch.from_numpy(chain["x"])
    for name in port.layer_names:
        carry = port.apply_layer(name, chain["params"][name], carry)
    want = chain["carries"][-1]["h"]
    assert_close(carry["h"].numpy(), want)
    assert (carry["h"].numpy().argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 7])
@pytest.mark.parametrize("act", ["relu6", "relu", "none"])
def test_conv2d_matches_reference(k, stride, act):
    """k 1, 3 and 7 (the models') and an even k (asymmetric padding), at
    strides 1 and 2, with a non-trivial folded scale and bias."""
    rng = jax.random.PRNGKey(k * 10 + stride)
    p = RC.init_conv(rng, k, 5, 12)
    p = {**p, "scale": jnp.linspace(0.5, 1.5, 12), "bias": jnp.linspace(-0.2, 0.3, 12)}
    x = normal((2, 11, 13, 5), seed=k + stride)
    want = np.asarray(RC.conv2d(p, jnp.asarray(x), stride=stride, act=act))
    got = PC.conv2d(cnn_params_from_reference(to_np(p)), torch.from_numpy(x),
                    stride=stride, act=act)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_matches_reference(stride):
    p = to_np(RC.init_conv(jax.random.PRNGKey(stride), 3, 24, 24, depthwise=True))
    x = normal((2, 9, 9, 24), seed=stride)
    want = np.asarray(RC.conv2d(p, jnp.asarray(x), stride=stride, depthwise=True))
    got = PC.conv2d(cnn_params_from_reference(p), torch.from_numpy(x), stride=stride,
                    depthwise=True)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("k,stride", [(3, 2), (2, 2), (3, 1)])
def test_max_pool_pads_with_minus_infinity(k, stride):
    """On an all-negative input a zero pad would win the border windows;
    the reference pads with -inf, and so must the port: exact equality."""
    x = -1.0 - np.abs(normal((2, 9, 10, 3), seed=k))
    want = np.asarray(RC.max_pool(jnp.asarray(x), k, stride))
    got = PC.max_pool(torch.from_numpy(x), k, stride).numpy()
    assert (got < 0).all()
    np.testing.assert_array_equal(got, want)


def test_global_avg_pool_and_dense_match_reference():
    x = normal((3, 5, 4, 16), seed=0)
    want = np.asarray(RC.global_avg_pool(jnp.asarray(x)))
    got = PC.global_avg_pool(torch.from_numpy(x))
    assert_close(got.numpy(), want)
    p = to_np(RC.init_dense(jax.random.PRNGKey(1), 16, 10))
    p["b"] = np.linspace(-1, 1, 10).astype(np.float32)
    assert_close(PC.dense(cnn_params_from_reference(p), got).numpy(),
                 np.asarray(RC.dense(p, jnp.asarray(want))))


def test_converted_params_have_the_ports_layout(chain):
    """Conv kernels become OIHW in channels-last memory (depthwise
    (C, 1, k, k)); scales, biases and dense weights keep their shapes."""
    rparams = chain["rparams"]
    for name, p in chain["params"].items():
        convs = [(p[k], rparams[name][k]) for k in ("main", "proj") if k in p] or [(p, rparams[name])]
        for got, want in convs:
            if "w" not in got:
                continue
            w = np.asarray(want["w"])
            if w.ndim == 4:
                assert got["w"].shape == (w.shape[3], w.shape[2], w.shape[0], w.shape[1])
                assert got["w"].is_contiguous(memory_format=torch.channels_last)
                np.testing.assert_array_equal(got["w"].permute(2, 3, 1, 0).numpy(), w)
            else:
                np.testing.assert_array_equal(got["w"].numpy(), w)


def test_init_draws_he_normal_weights_from_the_generator(chain):
    """The port's own ``init``: the reference's shapes in the port's
    layout, He-normal spread, one draw per seed."""
    port = chain["port"]
    params = port.init(torch.Generator().manual_seed(5), device="cpu")
    again = port.init(torch.Generator().manual_seed(5), device="cpu")
    other = port.init(torch.Generator().manual_seed(6), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), chain["params"])
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params),
                                                   jax.tree.leaves(again)))
    first = port.layer_names[0]
    assert not torch.equal(params[first]["w"], other[first]["w"])
    w = params[first]["w"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.2
    assert torch.equal(port.init(device="cpu")[first]["w"],
                       port.init(torch.Generator().manual_seed(0), device="cpu")[first]["w"])


def test_ieee_float32_scope_restores_the_callers_settings():
    """The scope sets true float32, cuDNN benchmark off and deterministic
    algorithms, and puts back whatever the caller had."""
    knobs = _float32_knobs()
    cudnn = torch.backends.cudnn
    saved = [getattr(o, n) for o, n, _ in knobs]
    try:
        cudnn.benchmark, cudnn.deterministic = True, False
        before = [getattr(o, n) for o, n, _ in knobs]
        with PC.ieee_float32():
            assert [getattr(o, n) for o, n, _ in knobs] == [v for _, _, v in knobs]
            assert not cudnn.benchmark and cudnn.deterministic
        assert [getattr(o, n) for o, n, _ in knobs] == before
        with pytest.raises(KeyError):
            with PC.ieee_float32():
                raise KeyError("inside")
        assert [getattr(o, n) for o, n, _ in knobs] == before
    finally:
        for (o, n, _), v in zip(knobs, saved):
            setattr(o, n, v)
