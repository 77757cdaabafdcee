"""The port's parameter layouts and resharded checkpoints
(``mxnet_tpu_torch/parallel/layout.py``, ``checkpoint.py``) against the
JAX package's on the same numpy inputs: manifests, fingerprints and
reshards equal, states bitwise. A checkpoint root written by either
package reshards alike in the other."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu.parallel import layout as jlayout
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch.parallel import layout as tlayout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "embed.weight": rng.randn(13, 4).astype(np.float32),
        "dense.weight": rng.randn(4, 4).astype(np.float32),
        "dense.bias": rng.randn(4).astype(np.float32),
        "__opt__": b"optimizer-bytes",
        "__rng__": b"key-chain",
        "__data_cursor__": b'{"epoch": 0}',
    }


def _build(mod, state, world, sharded=("embed.weight",), mesh=None):
    shapes = {k: list(v.shape) for k, v in state.items()
              if not k.startswith("__")}
    return mod.LayoutManifest.build(shapes, world,
                                    sharded_axes={k: 0 for k in sharded},
                                    mesh=mesh)


def _same_states(a, b):
    assert sorted(a) == sorted(b)
    for r in a:
        assert sorted(a[r]) == sorted(b[r]), r
        for k in a[r]:
            x, y = a[r][k], b[r][k]
            if isinstance(x, (bytes, bytearray)):
                assert bytes(x) == bytes(y), (r, k)
            else:
                assert x.dtype == y.dtype and x.shape == y.shape, (r, k)
                np.testing.assert_array_equal(x, y, err_msg="%s/%s" % (r, k))


@pytest.mark.parametrize("n,world", [(1, 1), (7, 3), (13, 4), (64, 5),
                                     (3, 8)])
def test_partition_equals_jax(n, world):
    assert tlayout.partition(n, world) == jlayout.partition(n, world)


@pytest.mark.parametrize("world,mesh", [(1, None), (4, None), (3, None),
                                        (4, {"max_slots": 8})])
def test_manifest_and_fingerprint_equal_jax(world, mesh):
    st = _state()
    t = _build(tlayout, st, world, mesh=mesh)
    j = _build(jlayout, st, world, mesh=mesh)
    assert t.to_dict() == j.to_dict()
    assert t.fingerprint() == j.fingerprint()
    # each package reads the other's dict form
    assert tlayout.LayoutManifest.from_dict(j.to_dict()).fingerprint() \
        == j.fingerprint()
    assert jlayout.LayoutManifest.from_dict(t.to_dict()).fingerprint() \
        == t.fingerprint()
    for new_world in (1, 2, 6):
        assert t.reshard_to(new_world).to_dict() == \
            j.reshard_to(new_world).to_dict()
    for key in ("embed.weight", "dense.bias"):
        for rank in range(world):
            assert t.part_for(key, rank) == j.part_for(key, rank)


def test_infer_manifest_equals_jax():
    st = _state(1)
    assert tlayout.infer_manifest(st, 3).to_dict() == \
        jlayout.infer_manifest(st, 3).to_dict()
    assert tlayout.LayoutManifest.replicated(
        {"a": [2, 3]}, 2).fingerprint() == jlayout.LayoutManifest.replicated(
        {"a": [2, 3]}, 2).fingerprint()


@pytest.mark.parametrize("old,new", [(4, 3), (4, 6), (2, 1), (1, 3)])
def test_shard_gather_reshard_states_bitwise_jax(old, new):
    full = _state(2)
    t_man = _build(tlayout, full, old)
    j_man = _build(jlayout, full, old)
    t_states = {r: tlayout.shard_state(full, t_man, r) for r in range(old)}
    j_states = {r: jlayout.shard_state(full, j_man, r) for r in range(old)}
    _same_states(t_states, j_states)
    gathered = tlayout.gather_state(t_states, t_man)
    _same_states({0: gathered}, {0: jlayout.gather_state(j_states, j_man)})
    for k, v in full.items():
        if k != "__data_cursor__" and not isinstance(v, bytes):
            np.testing.assert_array_equal(gathered[k], v)
    t_new, t_nm = tlayout.reshard_states(t_states, t_man, new)
    j_new, j_nm = jlayout.reshard_states(j_states, j_man, new)
    assert t_nm.to_dict() == j_nm.to_dict()
    _same_states(t_new, j_new)
    assert all("__data_cursor__" not in s for s in t_new.values())


def test_validate_refuses_what_jax_refuses():
    bad = _build(tlayout, _state(), 2).to_dict()
    bad["entries"]["embed.weight"]["parts"] = [[0, 5], [6, 13]]
    for mod in (tlayout, jlayout):
        with pytest.raises(ValueError):
            mod.LayoutManifest.from_dict(bad).validate()


def _save_world(mod, root, states, man, step=5):
    world = man.world
    for r in range(world):
        cm = mod.CheckpointManager(root, rank=r, world=world,
                                   async_save=False)
        cm.save(states[r], step, epoch=1, nbatch=2,
                meta={"layout": man.to_dict()})


def test_reshard_checkpoint_and_restore_resharded_equal_jax(tmp_path):
    """A 4-rank root written by the port: the port's and the JAX
    package's ``reshard_checkpoint`` to 3 ranks write the same states and
    layout; ``restore_resharded`` at world 3 and world 1 gives each rank
    its slice, bitwise."""
    full = _state(3)
    man = _build(tlayout, full, 4)
    states = {r: tlayout.shard_state(full, man, r) for r in range(4)}
    src = str(tmp_path / "w4")
    _save_world(tckpt, src, states, man)
    # every snapshot carries its layout record
    with open(os.path.join(src, "rank_0", "ckpt-5.json")) as f:
        assert json.load(f)["meta"]["layout"] == man.to_dict()
    rep_t = tckpt.reshard_checkpoint(src, 3, dst_root=str(tmp_path / "t3"))
    rep_j = jckpt.reshard_checkpoint(src, 3, dst_root=str(tmp_path / "j3"))
    for k in ("step", "old_world", "new_world", "params",
              "layout_fingerprint"):
        assert rep_t[k] == rep_j[k], k
    for r in range(3):
        a, ma = tckpt.CheckpointManager(str(tmp_path / "t3"), rank=r,
                                        world=3).restore()
        b, mb = jckpt.CheckpointManager(str(tmp_path / "j3"), rank=r,
                                        world=3).restore()
        _same_states({r: a}, {r: b})
        assert ma["meta"]["layout"] == mb["meta"]["layout"]
        assert ma["meta"]["resharded_from"] == {"world": 4, "step": 5}
    for world in (3, 1):
        want, _ = jlayout.reshard_states(
            {r: jlayout.shard_state(full, _build(jlayout, full, 4), r)
             for r in range(4)}, _build(jlayout, full, 4), world)
        for r in range(world):
            got, m = tckpt.CheckpointManager(src, rank=r, world=world) \
                .restore_resharded()
            _same_states({r: got}, {r: want[r]})
            assert m["meta"]["resharded_from"] == {"world": 4, "step": 5}
            assert m["world"] == world and m["rank"] == r


def test_restore_resharded_uses_newest_common_step(tmp_path):
    """A rank that died before its last save vetoes that step: the
    reshard reads the newest step every rank committed."""
    full = _state(4)
    man = _build(tlayout, full, 2)
    states = {r: tlayout.shard_state(full, man, r) for r in range(2)}
    root = str(tmp_path / "w2")
    _save_world(tckpt, root, states, man, step=3)
    newer = {k: (v + 1 if isinstance(v, np.ndarray) else v)
             for k, v in states[0].items()}
    tckpt.CheckpointManager(root, rank=0, world=2, async_save=False).save(
        newer, 4, meta={"layout": man.to_dict()})
    got, m = tckpt.CheckpointManager(root, rank=0, world=1) \
        .restore_resharded()
    assert m["meta"]["resharded_from"]["step"] == 3
    np.testing.assert_array_equal(got["embed.weight"], full["embed.weight"])


def test_reshard_tool_prints_the_report(tmp_path):
    full = _state(5)
    man = _build(tlayout, full, 2)
    states = {r: tlayout.shard_state(full, man, r) for r in range(2)}
    src = str(tmp_path / "run")
    _save_world(tckpt, src, states, man)
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.reshard",
         "--checkpoint", src, "--world", "3"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["dst"] == src + "-w3" and rep["new_world"] == 3
    assert sorted(os.listdir(src + "-w3")) == ["rank_0", "rank_1", "rank_2"]
    assert mt.checkpoint.CheckpointManager(src + "-w3", rank=2, world=3) \
        .restore()[0] is not None
