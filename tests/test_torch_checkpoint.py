"""The port's checkpoint manager (repro_torch.checkpoint) against the JAX
package's (tests/test_checkpoint.py), on the CPU: its cases on the port's
manager (bit-exact round trip, async writes, retention, corruption), a
resume of scene training bitwise equal to training straight through, files
written by either package restored leaf for leaf and in the same order by
the other (nested dicts, lists, tuples and a GaussianScene), restore onto a
named device, the uncompressed path without ``zstandard``, and bf16 leaves:
a bitwise round trip, a JAX-written bf16 file restored by the port, and a
port-written one that the JAX manager reads back with its own bytes."""
from __future__ import annotations

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core.gaussians import random_scene as jax_random_scene
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as manager_module
from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.optim.adamw import adamw_init


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(32, 16, generator=g),
        "nested": {"b": torch.arange(7, dtype=torch.int32)},
    }


def test_roundtrip_bit_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = _tree(0)
    mgr.save(10, tree, extra={"rng": 123})
    leaves, manifest = mgr.restore()
    orig, _ = tree_flatten(tree)
    assert manifest["step"] == 10
    assert manifest["extra"]["rng"] == 123
    assert len(leaves) == len(orig) == 2
    for a, b in zip(orig, leaves):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_write_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    for s in (1, 2):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert mgr.all_steps() == [1, 2]


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


@pytest.mark.parametrize("compressed", [True, False], ids=["zstd", "plain"])
def test_corruption_detected(tmp_path, monkeypatch, compressed):
    zstandard = manager_module.zstandard
    if not compressed:
        monkeypatch.setattr(manager_module, "zstandard", None)
    elif zstandard is None:
        pytest.skip("zstandard is not installed")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _tree(0))
    path = mgr.latest().path
    raw = bytearray(open(path, "rb").read())
    if compressed:  # flip a byte of the DECOMPRESSED payload
        raw = bytearray(zstandard.ZstdDecompressor().decompress(bytes(raw)))
    raw[len(raw) // 2] ^= 0xFF
    blob = bytes(raw)
    if compressed:
        blob = zstandard.ZstdCompressor(level=3).compress(blob)
    open(path, "wb").write(blob)
    # Either the container CRC or the per-leaf sha256 must refuse the load.
    with pytest.raises((IOError, zipfile.BadZipFile)):
        mgr.restore()


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path), async_write=False).restore()


def test_resume_reproduces_scene_training(tmp_path):
    """Train 4 steps straight == train 2, checkpoint scene and AdamW state,
    restore, rebuild the tree, train 2 (the port's stand-in for the JAX
    package's LM resume test; the LM stack is not ported)."""
    from repro_torch.core.camera import make_camera
    from repro_torch.core.gaussians import random_scene
    from repro_torch.core.pipeline import RenderConfig, render
    from repro_torch.core.train import SceneTrainConfig, make_train_step

    scene = random_scene(300, extent=2.5, generator=torch.Generator().manual_seed(3))
    cam = make_camera((0.0, 1.0, 4.0), (0, 0, 0), 32, 32)
    cfg = RenderConfig(group_capacity=256, tile_capacity=256)
    target = render(random_scene(300, extent=2.5, generator=torch.Generator().manual_seed(4)),
                    cam, cfg).image
    step = make_train_step(cam, cfg, SceneTrainConfig())

    def train(s, o, steps):
        for i in steps:
            s, o, _, _ = step(s, o, target, i)
        return s, o

    straight, _ = train(scene, adamw_init(scene), range(4))
    s, o = train(scene, adamw_init(scene), range(2))
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"params": s, "opt": o})
    leaves, manifest = mgr.restore()
    assert manifest["step"] == 2 and manifest["n_leaves"] == 15
    restored = tree_unflatten({"params": s, "opt": o}, leaves)
    resumed, _ = train(restored["params"], restored["opt"], range(2, 4))
    for a, b in zip(tree_flatten(straight)[0], tree_flatten(resumed)[0]):
        assert torch.equal(a, b)


# -- across the two packages ---------------------------------------------------


def _jax_tree():
    scene = jax_random_scene(jax.random.key(2), 40, extent=2.0)
    return {
        "scene": scene,
        "opt": {"mu": [jnp.zeros((3, 2)), (jnp.arange(5, dtype=jnp.int32), None)],
                "count": jnp.asarray(7, dtype=jnp.int32)},
        "a": jnp.linspace(0.0, 1.0, 9, dtype=jnp.float32),
    }


def _port_tree(jtree):
    def t(x):
        return torch.from_numpy(np.array(x))

    return {
        "scene": scene_from_numpy(jtree["scene"], "cpu"),
        "opt": {"mu": [t(jtree["opt"]["mu"][0]), (t(jtree["opt"]["mu"][1][0]), None)],
                "count": t(jtree["opt"]["count"])},
        "a": t(jtree["a"]),
    }


@pytest.mark.parametrize("compressed", [True, False], ids=["zstd", "plain"])
def test_checkpoints_cross_restore_between_packages(tmp_path, monkeypatch, compressed):
    from repro.checkpoint import manager as jax_manager_module

    if not compressed:
        monkeypatch.setattr(manager_module, "zstandard", None)
        monkeypatch.setattr(jax_manager_module, "zstandard", None)
    jtree = _jax_tree()
    ptree = _port_tree(jtree)
    jleaves = jax.tree.leaves(jtree)
    pleaves, treedef = tree_flatten(ptree)
    assert len(jleaves) == len(pleaves) == 9
    assert treedef.startswith("PyTreeDef({'a': *, 'opt': {'count': *, 'mu': [*, (*, None)]}")

    JManager(str(tmp_path / "jax"), async_write=False).save(3, jtree, extra={"by": "jax"})
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(3, ptree)
    from_jax, manifest = CheckpointManager(str(tmp_path / "jax"), async_write=False).restore()
    from_port, _ = JManager(str(tmp_path / "port"), async_write=False).restore()
    assert manifest["extra"] == {"by": "jax"}
    for j, p, a, b in zip(jleaves, pleaves, from_jax, from_port):
        assert a.numpy().dtype == np.asarray(j).dtype and b.dtype == p.numpy().dtype
        assert a.numpy().tobytes() == np.asarray(j).tobytes()
        assert b.tobytes() == p.numpy().tobytes()
    back = tree_unflatten(ptree, from_jax)
    assert type(back["scene"]) is type(ptree["scene"]) and back["opt"]["mu"][1][1] is None
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(back)[0], pleaves))


def test_restore_onto_a_named_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _tree(1))
    leaves, _ = mgr.restore(device="cpu")
    assert all(x.device == torch.device("cpu") for x in leaves)
    leaves, _ = mgr.restore(1, device=torch.device("meta"))
    assert all(x.device.type == "meta" for x in leaves)


def test_uncompressed_without_zstandard(tmp_path, monkeypatch):
    """With ``zstandard`` missing the file is a plain npz; a zstd file then
    refuses to load with ImportError, as in the JAX package."""
    monkeypatch.setattr(manager_module, "zstandard", None)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _tree(1))
    assert open(mgr.latest().path, "rb").read(2) == b"PK"
    leaves, _ = mgr.restore()
    assert torch.equal(leaves[1], _tree(1)["w"])
    monkeypatch.undo()
    if manager_module.zstandard is None:
        pytest.skip("zstandard is not installed: no zstd file to refuse")
    mgr.save(2, _tree(2))
    monkeypatch.setattr(manager_module, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        mgr.restore(2)


# -- bf16 leaves ------------------------------------------------------------------

def _bf16_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "b": torch.randn(3, generator=g).to(torch.bfloat16),
            "s": torch.randn((), generator=g).to(torch.bfloat16),
            "mu": torch.randn(5, 7, generator=g)}


def test_bf16_roundtrip_is_bitwise(tmp_path):
    """A bf16 leaf (0-d too) saves as its bits and restores as bf16, bit for
    bit, beside a float32 leaf; on a named device too."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = _bf16_tree(0)
    mgr.save(4, tree)
    for device in (None, "cpu"):
        leaves, _ = mgr.restore(device=device)
        orig, _ = tree_flatten(tree)
        for a, b in zip(orig, leaves):
            assert b.dtype == a.dtype and b.shape == a.shape
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_bf16_file_of_the_jax_manager_restores_in_the_port(tmp_path):
    """The JAX manager writes a bf16 leaf as 2-byte voids; the port restores
    it as bf16 with the same bits, and refuses a void of another width."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    jtree = {"w": w, "x": jnp.asarray(rng.standard_normal(3), jnp.float32)}
    JManager(str(tmp_path), async_write=False).save(2, jtree)
    leaves, _ = CheckpointManager(str(tmp_path), async_write=False).restore()
    assert leaves[0].dtype == torch.bfloat16 and leaves[1].dtype == torch.float32
    np.testing.assert_array_equal(leaves[0].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
    np.testing.assert_array_equal(leaves[1].numpy(), np.asarray(jtree["x"]))
    with pytest.raises(TypeError, match="V4"):
        manager_module._tensor(np.zeros(3, np.int32).view("V4"))


def test_bf16_file_of_the_port_restores_in_the_jax_manager(tmp_path):
    """The port's bf16 leaf is byte for byte the JAX manager's own: the
    same 2-byte-void array back from the JAX manager's restore, with the
    same bytes and sha256 as the JAX package's save of the same values."""
    tree = _bf16_tree(1)
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(1, tree)
    jtree = {k: jnp.asarray(v.float().numpy(), jnp.dtype(str(v.dtype).split(".")[1]))
             for k, v in tree.items()}
    JManager(str(tmp_path / "jax"), async_write=False).save(1, jtree)
    from_port, port_manifest = JManager(str(tmp_path / "port"), async_write=False).restore()
    own, jax_manifest = JManager(str(tmp_path / "jax"), async_write=False).restore()
    assert port_manifest["hashes"] == jax_manifest["hashes"]
    assert port_manifest["treedef"] == jax_manifest["treedef"]
    for a, b in zip(from_port, own):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert [a.dtype.str for a in from_port] == ["|V2", "<f4", "|V2", "|V2"]  # b, mu, s, w
