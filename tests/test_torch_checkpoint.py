"""The port's checkpoint manager (``repro_torch.checkpoint.manager``) on the
CPU: the reference's checkpoint cases (``tests/test_checkpoint_runtime.py``)
and its hypothesis round trip (``tests/test_property.py``) on the port;
the on-disk format against the reference's manager in both directions
(each restores what the other wrote, bit for bit, bf16 included, and the
manifests are equal); an async save immune to the optimizer's in-place
update; a writer error surfacing at ``wait()``.  Restores compare exactly:
a checkpoint stores the bits.
"""

import json
import os
import threading
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.utils.trees import flatten_with_paths, tree_leaves, tree_map

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.randn(3, generator=g).to(torch.bfloat16)}}


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# --------------------------------------------------------------------------
# the reference's cases, on the port
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(7, t, extra={"note": "hi"}, blocking=True)
    assert mgr.latest_step() == 7
    restored = mgr.restore(7, _meta(t), device="cpu")
    assert _equal(t, restored)
    assert mgr.restore_extra(7)["note"] == "hi"


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_ignores_partial_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(), blocking=True)
    # a crashed save leaves a tmp dir: must not be listed as a step
    os.makedirs(tmp_path / "step_9.tmp.1234")
    assert mgr.all_steps() == [1]
    # a committed dir without manifest is also ignored
    os.makedirs(tmp_path / "step_8")
    assert mgr.all_steps() == [1]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"a": torch.zeros(2, 2)}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": torch.empty(3, 3, device="meta")}, device="cpu")
    with pytest.raises(KeyError):
        mgr.restore(1, {"b": torch.empty(2, 2, device="meta")}, device="cpu")


@given(shapes=st.lists(st.tuples(st.integers(1, 5), st.integers(1, 5)),
                       min_size=1, max_size=4),
       seed=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_checkpoint_roundtrip_arbitrary_trees(shapes, seed, tmp_path_factory):
    rng = np.random.default_rng(seed)
    tree = {f"k{i}": torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for i, s in enumerate(shapes)}
    d = tmp_path_factory.mktemp("ckpt")
    mgr = CheckpointManager(str(d), keep=1)
    mgr.save(1, tree, blocking=True)
    assert _equal(tree, mgr.restore(1, _meta(tree), device="cpu"))


# --------------------------------------------------------------------------
# the on-disk format, both ways
# --------------------------------------------------------------------------

class State(NamedTuple):
    params: Any
    layers: Any
    step: Any
    error_buf: Any = None


def _numpy_state():
    """fp32, int32 and bf16 leaves (bf16 as fp32 values it holds exactly)
    in nested dicts, a list and a named tuple, with a ``None`` subtree."""
    rng = np.random.default_rng(5)
    bf = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    return State(
        params={"w": rng.normal(size=(4, 6)).astype(np.float32),
                "norm": {"scale": bf, "ids": np.arange(7, dtype=np.int32)}},
        layers=[rng.normal(size=(2,)).astype(np.float32),
                rng.normal(size=(2, 3)).astype(np.float32)],
        step=7)


def _as_jax(s):
    return State(
        params={"w": jnp.asarray(s.params["w"]),
                "norm": {"scale": jnp.asarray(s.params["norm"]["scale"],
                                              jnp.bfloat16),
                         "ids": jnp.asarray(s.params["norm"]["ids"])}},
        layers=[jnp.asarray(x) for x in s.layers],
        step=jnp.asarray(s.step, jnp.int32))


def _as_torch(s):
    return State(
        params={"w": torch.from_numpy(s.params["w"]),
                "norm": {"scale": torch.from_numpy(s.params["norm"]["scale"])
                         .to(torch.bfloat16),
                         "ids": torch.from_numpy(s.params["norm"]["ids"])}},
        layers=[torch.from_numpy(x) for x in s.layers],
        step=s.step)


def _bits(x):
    """A leaf's bits as numpy (bf16 as its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def test_port_restores_what_the_reference_wrote(tmp_path):
    ref = _as_jax(_numpy_state())
    JCheckpointManager(str(tmp_path), keep=1).save(7, ref, blocking=True,
                                                   extra={"step": 7})
    template = _as_torch(_numpy_state())
    got = CheckpointManager(str(tmp_path)).restore(7, _meta_state(template),
                                                   device="cpu")
    assert isinstance(got, State) and got.error_buf is None
    assert got.step == 7 and type(got.step) is int
    want = flatten_with_paths(ref)
    have = flatten_with_paths(got)
    assert sorted(have) == sorted(want)
    for k, v in have.items():
        if k == "step":
            continue
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)


def _meta_state(s):
    return s._replace(params=_meta(s.params), layers=_meta(s.layers))


def test_reference_restores_what_the_port_wrote(tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    mine = _as_torch(_numpy_state())
    CheckpointManager(str(port_dir), keep=1).save(7, mine, blocking=True,
                                                  extra={"step": 7})
    ref = _as_jax(_numpy_state())
    JCheckpointManager(str(ref_dir), keep=1).save(7, ref, blocking=True,
                                                  extra={"step": 7})
    # the same manifest, and the same file names
    assert _manifest(port_dir, 7) == _manifest(ref_dir, 7)
    assert sorted(os.listdir(port_dir / "step_7")) == \
        sorted(os.listdir(ref_dir / "step_7"))
    got = JCheckpointManager(str(port_dir)).restore(
        7, jax.eval_shape(lambda: ref))
    assert int(got.step) == 7 and got.step.dtype == jnp.int32
    want = flatten_with_paths(mine)
    for k, v in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                      getattr(p, "name", p))))
                       for p in k)
        if key == "step":
            continue
        assert str(v.dtype) == str(want[key].dtype).removeprefix("torch."), key
        np.testing.assert_array_equal(_bits(v), _bits(want[key]),
                                      err_msg=key)


def test_flatten_with_paths_names_leaves_as_the_reference():
    from repro.utils.trees import flatten_with_paths as jflatten

    s = _numpy_state()
    assert list(flatten_with_paths(_as_torch(s))) == \
        list(jflatten(_as_jax(s)))


# --------------------------------------------------------------------------
# the snapshot, and the writer's errors
# --------------------------------------------------------------------------

def test_async_save_is_immune_to_in_place_updates(tmp_path, monkeypatch):
    """The writer thread is held until every leaf was updated in place, as
    the optimizer's next step updates them: the checkpoint still holds
    the values at the save."""
    release = threading.Event()
    real_save = np.save

    def held_save(*a, **kw):
        assert release.wait(timeout=30)
        return real_save(*a, **kw)

    monkeypatch.setattr(np, "save", held_save)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    t = _tree()
    want = tree_map(torch.clone, t)
    mgr.save(1, t, blocking=False)
    with torch.no_grad():
        for leaf in tree_leaves(t):
            leaf.add_(1)
    release.set()
    mgr.wait()
    assert _equal(mgr.restore(1, _meta(t), device="cpu"), want)


def test_writer_error_surfaces_at_wait(tmp_path, monkeypatch):
    def failing_save(*a, **kw):
        raise OSError("disk full")

    mgr = CheckpointManager(str(tmp_path), keep=1)
    monkeypatch.setattr(np, "save", failing_save)
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [] and os.listdir(tmp_path) == []
    monkeypatch.undo()
    mgr.wait()  # the error was raised once
    mgr.save(2, _tree(), blocking=True)
    assert mgr.all_steps() == [2]
