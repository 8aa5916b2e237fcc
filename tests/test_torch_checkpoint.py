"""The port's checkpoint store (``repro_torch.checkpoint.store``): the
reference store tests' behaviours, bfloat16 kept exactly, the async
snapshot taken before the thread starts, and the reference's layout
(a checkpoint the reference writes restores in the port)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as RefStore
from repro_torch.checkpoint import store as S
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init


def tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.randn((2, 3), generator=g).bfloat16(),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "e": [torch.ones(4, dtype=torch.float64), np.arange(3, dtype=np.int64)]}


def zeros_like(t):
    if isinstance(t, dict):
        return {k: zeros_like(v) for k, v in t.items()}
    if isinstance(t, list):
        return [zeros_like(v) for v in t]
    return torch.zeros_like(t) if isinstance(t, torch.Tensor) else np.zeros_like(t)


def assert_trees_equal(got, want):
    for g, w in zip(S.tree_leaves(got), S.tree_leaves(want), strict=True):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_save_restore_roundtrip_keeps_types_exactly(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    path = store.save(3, t, extra={"next_step": 3})
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["n_leaves"] == 5 and manifest["step"] == 3
    assert sorted(p.name for p in path.iterdir()) == ["manifest.json", "shard_0.npz"]
    with np.load(path / "shard_0.npz") as arrays:
        assert arrays["leaf_1"].dtype == np.float32  # bf16 stored widened, exactly
    restored, extra = store.restore(zeros_like(t))
    assert extra == {"next_step": 3}
    assert_trees_equal(restored, t)


def test_module_and_optimizer_state_restore_in_place(tmp_path):
    """A bf16 model and its float32 moments: restored into a template of
    other values, the module's own tensors are written, bit for bit."""
    cfg = get_config("deepseek-7b").reduced(dtype="bfloat16")
    model = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(model)
    with torch.no_grad():
        for v in opt["mu"].values():
            v.normal_()
    store = CheckpointStore(tmp_path)
    store.save(1, (model, opt), extra={"next_step": 1})
    other = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    table = other.embed.table
    (got, got_opt), _ = store.restore((other, adamw_init(other)))
    assert got is other and got.embed.table is table
    assert_trees_equal(got, model)
    assert_trees_equal(got_opt, opt)


def test_retention(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, {"x": torch.zeros(3)})
    assert store.steps() == [3, 4] and store.latest_step() == 4


def test_corruption_detected(tmp_path):
    store = CheckpointStore(tmp_path)
    t = {"x": torch.arange(10.0)}
    shard = store.save(1, t) / "shard_0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corrupt"):
        store.restore(t)


def test_structure_change_and_empty_store_refused(tmp_path):
    store = CheckpointStore(tmp_path)
    with pytest.raises(FileNotFoundError):
        store.restore({"x": torch.zeros(1)})
    store.save(1, {"x": torch.zeros(1)})
    with pytest.raises(ValueError, match="structure changed"):
        store.restore({"x": torch.zeros(1), "y": torch.zeros(1)})


def test_async_save(tmp_path):
    store = CheckpointStore(tmp_path)
    t = {"x": torch.arange(100.0)}
    store.save_async(5, t, extra={"next_step": 5})
    store.wait()
    restored, extra = store.restore({"x": torch.zeros(100)})
    assert torch.equal(restored["x"], t["x"]) and extra == {"next_step": 5}


def test_in_place_update_after_save_async_does_not_reach_the_file(tmp_path, monkeypatch):
    """The snapshot is copied before the writer starts: on the CPU
    ``t.cpu()`` and ``t.numpy()`` alias the live tensor, and the next
    in-place AdamW step would race the writer. The writer is held until
    the tensor has been overwritten."""
    store = CheckpointStore(tmp_path)
    live = torch.arange(1000.0)
    want = live.clone()
    release = __import__("threading").Event()
    save = store.save
    monkeypatch.setattr(store, "save", lambda *a, **k: release.wait(5) and save(*a, **k))
    store.save_async(1, {"w": live})
    live.mul_(-1.0)  # the next step, in place
    release.set()
    store.wait()
    restored, _ = store.restore({"w": torch.zeros(1000)})
    assert torch.equal(restored["w"], want)


def test_atomic_publish_keeps_the_newest_checkpoint(tmp_path, monkeypatch):
    """A writer that dies mid-save publishes nothing: the newest
    checkpoint stays the last complete one, and the async failure is
    raised by ``wait``."""
    store = CheckpointStore(tmp_path)
    store.save(2, {"x": torch.full((4,), 2.0)})

    def dying_savez(path, **arrays):
        path.write_bytes(b"partial")
        raise OSError("disk gone")

    monkeypatch.setattr(S.np, "savez", dying_savez)
    with pytest.raises(OSError, match="disk gone"):
        store.save(4, {"x": torch.full((4,), 4.0)})
    store.save_async(6, {"x": torch.full((4,), 6.0)})
    with pytest.raises(OSError, match="disk gone"):
        store.wait()
    monkeypatch.undo()
    assert store.steps() == [2]
    restored, _ = store.restore({"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.full((4,), 2.0))


def test_restores_a_checkpoint_the_reference_wrote(tmp_path):
    """The layout is the reference's: dict leaves in sorted key order,
    ``leaf_<i>`` in one shard, the manifest's crc32."""
    rng = np.random.RandomState(1)
    ref = {"w": rng.standard_normal((3, 4)).astype(np.float32),
           "n": {"b": np.arange(5, dtype=np.int32), "a": rng.standard_normal(2)}}
    RefStore(tmp_path).save(9, {"w": jnp.asarray(ref["w"]),
                                "n": {"b": jnp.asarray(ref["n"]["b"]),
                                      "a": jnp.asarray(ref["n"]["a"], jnp.float32)}},
                            extra={"next_step": 9})
    template = {"w": torch.zeros((3, 4)), "n": {"b": torch.zeros(5, dtype=torch.int32),
                                               "a": torch.zeros(2)}}
    got, extra = CheckpointStore(tmp_path).restore(template)
    assert extra == {"next_step": 9}
    assert torch.equal(got["w"], torch.from_numpy(ref["w"]))
    assert torch.equal(got["n"]["b"], torch.from_numpy(ref["n"]["b"]))
    assert torch.equal(got["n"]["a"], torch.from_numpy(ref["n"]["a"].astype(np.float32)))
