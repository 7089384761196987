"""The port's checkpoint manager: the seven cases of
``tests/test_checkpoint.py`` on trees of tensors, bfloat16 round-tripped
bit for bit (numpy has none: its raw 16-bit words are stored), restore
onto each template leaf's dtype, and checkpoints of float32 and int32
trees read across both ways with the reference's ``CheckpointManager``.
Every comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager, encode_key, fsync_dir
from repro_torch.models.common import tree_leaves, tree_map


@pytest.fixture()
def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.zeros((), dtype=torch.float32)}}


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree, extra={"note": "hi"})
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 7
    assert manifest["extra"]["note"] == "hi"
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        _equal(a, b)


def test_keep_k_gc(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_restore_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 5, 3):
        mgr.save(s, tree_map(lambda x: x + s, tree))
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 5
    torch.testing.assert_close(restored["a"], tree["a"] + 5, rtol=0, atol=0)


def test_partial_checkpoint_ignored(tmp_path, tree):
    """A crash mid-write (no manifest committed) must be invisible."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    fake = os.path.join(str(tmp_path), "step_0000000099")
    os.makedirs(fake)
    np.save(os.path.join(fake, "a.npy"), np.zeros(3))  # no manifest.json
    assert mgr.latest_step() == 1
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 1


def test_empty_dir(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    restored, manifest = mgr.restore(tree)
    assert restored is None and manifest is None


def test_adversarial_key_names_round_trip(tmp_path):
    """Keys containing ``__``, ``/``, ``%`` and non-ASCII each get their
    own file (percent-encoding is injective)."""
    tree = {"a__b": torch.full((3,), 1.0),
            "a": {"b": torch.full((3,), 2.0)},
            "weird/_%_name": torch.full((2,), 3.0),
            "uniçode": torch.full((2,), 4.0)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 1
    assert len({e["file"] for e in manifest["leaves"]}) == \
        len(manifest["leaves"]) == 4
    _equal(restored["a__b"], torch.full((3,), 1.0))
    _equal(restored["a"]["b"], torch.full((3,), 2.0))
    assert encode_key("a/b") != encode_key("a__b")


def test_committed_checkpoint_gated_on_manifest(tmp_path, tree):
    """A step dir that lost its manifest is not a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(3, tree)
    fsync_dir(str(tmp_path))
    assert mgr.all_steps() == [3]
    os.unlink(os.path.join(path, "manifest.json"))
    assert mgr.all_steps() == []


def test_bfloat16_round_trips_bit_for_bit(tmp_path):
    """bfloat16 leaves (random, with a NaN, an inf, a subnormal and -0)
    come back bit for bit; the manifest names their dtype, the file holds
    their 16-bit words."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((4, 7), generator=g).bfloat16()
    w[0, :4] = torch.tensor([float("nan"), float("inf"), 1e-40, -0.0])
    tree = {"w": w, "stack": {"x": torch.randn((2, 3, 5), generator=g)
                              .bfloat16()}}
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, tree)
    restored, manifest = mgr.restore(tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert b.dtype == torch.bfloat16 and b.shape == a.shape
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    entry = {e["key"]: e for e in manifest["leaves"]}["w"]
    assert entry["dtype"] == "bfloat16" and entry["shape"] == [4, 7]
    raw = np.load(os.path.join(path, entry["file"]))
    assert raw.dtype == np.uint16
    assert raw.tobytes() == w.view(torch.int16).numpy().tobytes()


def test_restore_takes_the_template_leaf_dtype(tmp_path, tree):
    """Each leaf comes back in its template leaf's dtype (and device): a
    float32 checkpoint restored into a bfloat16 template is rounded once,
    as a cast would round it; a numpy template leaf gets a numpy array."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    template = {"a": tree["a"].bfloat16(),
                "b": {"c": np.zeros((5,), np.int64), "d": tree["b"]["d"]}}
    restored, _ = mgr.restore(template)
    _equal(restored["a"], tree["a"].bfloat16())
    assert isinstance(restored["b"]["c"], np.ndarray)
    assert restored["b"]["c"].dtype == np.int64
    np.testing.assert_array_equal(restored["b"]["c"], np.ones(5))


def test_reference_reads_port_checkpoints(tmp_path, tree):
    """A float32/int32 checkpoint the port wrote is restored by the
    reference's ``CheckpointManager`` leaf for leaf, with its manifest."""
    CheckpointManager(str(tmp_path)).save(4, tree, extra={"by": "port"})
    jtemplate = {"a": jnp.zeros((3, 4)),
                 "b": {"c": jnp.zeros((5,), jnp.int32),
                       "d": jnp.zeros((), jnp.float32)}}
    restored, manifest = JManager(str(tmp_path)).restore(jtemplate)
    assert manifest["step"] == 4 and manifest["extra"] == {"by": "port"}
    np.testing.assert_array_equal(np.asarray(restored["a"]),
                                  tree["a"].numpy())
    assert np.asarray(restored["b"]["c"]).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(restored["b"]["c"]),
                                  np.ones(5, np.int32))


def test_port_reads_reference_checkpoints(tmp_path, tree):
    """A checkpoint the reference wrote (``keep`` 2 of three steps) is
    listed and restored by the port's manager, leaf for leaf."""
    jtree = {"a": jnp.arange(12.0).reshape(3, 4),
             "b": {"c": jnp.ones((5,), jnp.int32),
                   "d": jnp.zeros((), jnp.float32)}}
    jm = JManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        jm.save(s, {"a": jtree["a"] + s, "b": jtree["b"]})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 3
    _equal(restored["a"], tree["a"] + 3)
    _equal(restored["b"]["c"], tree["b"]["c"])
    restored, _ = mgr.restore(tree, step=2)
    _equal(restored["a"], tree["a"] + 2)
