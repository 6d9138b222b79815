"""The port's checkpoint module: the twins of tests/test_infra.py's
checkpoint tests, the on-disk format shared with the JAX package (a tree
saved by either restores in the other, bit for bit, bf16 included), and a
resumed training run equal to an uninterrupted one.

The twin of test_elastic_restore_across_meshes (a restore onto a mesh of
another size) is in tests/test_torch_dist_training.py, on gloo ranks.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones((4,), dtype=torch.bfloat16) * 1.5,
              "d": torch.tensor(3, dtype=torch.int32)},
    }
    ck.save(tree, str(tmp_path), 7)
    like = {"a": torch.empty((2, 3), device="meta"),
            "b": {"c": torch.empty((4,), dtype=torch.bfloat16, device="meta"),
                  "d": torch.empty((), dtype=torch.int32, device="meta")}}
    out = ck.restore(str(tmp_path), 7, like, device="cpu")
    assert out["b"]["c"].dtype == torch.bfloat16 and out["b"]["d"].dtype == torch.int32
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert int(out["b"]["d"]) == 3


def test_checkpoint_atomicity(tmp_path):
    tree = {"x": torch.zeros((2,))}
    ck.save(tree, str(tmp_path), 1)
    # a crashed write leaves only .tmp — must be ignored
    os.makedirs(tmp_path / "step_9.tmp")
    assert ck.latest_step(str(tmp_path)) == 1


def test_async_checkpointer(tmp_path):
    tree = {"x": torch.arange(4.0)}
    ac = ck.AsyncCheckpointer(str(tmp_path))
    ac.save(tree, 3)
    tree["x"].add_(100.0)            # the snapshot was taken before the writer started
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 3
    out = ck.restore(str(tmp_path), 3, {"x": torch.empty(4)})
    assert torch.equal(out["x"], torch.arange(4.0))


def _numpy_tree(seed=0):
    """bf16, f32 and int32 leaves, nested in dicts and a list, as numpy."""
    rng = np.random.default_rng(seed)
    bf16 = np.asarray(jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16))
    return {
        "blocks": [{"w": bf16, "b": rng.normal(size=(5,)).astype(np.float32)},
                   {"w": bf16[::-1].copy(), "b": rng.normal(size=(5,)).astype(np.float32)}],
        "step": np.asarray(11, np.int32),
        "m": rng.normal(size=(2, 2)).astype(np.float32),
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _bits(a):
    """A leaf's bytes, from a torch tensor or a numpy / JAX array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _numpy_tree(1)
    jck.save(jax.tree.map(jnp.asarray, tree), str(tmp_path), 5, extra={"who": "jax"})
    like = _as_torch(tree)
    out = ck.restore(str(tmp_path), 5, like, device="cpu")
    assert out["blocks"][1]["w"].dtype == torch.bfloat16 and out["step"].dtype == torch.int32
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_flatten_with_path(out)[0], strict=True):
        assert pa == pb and _bits(a) == _bits(b)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _numpy_tree(2)
    ck.save(_as_torch(tree), str(tmp_path), 6, extra={"who": "port"})
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    out = jck.restore(str(tmp_path), 6, like)
    assert out["blocks"][0]["w"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(out), strict=True):
        assert _bits(a) == _bits(b)
    # both packages write the same manifest for the same tree
    jck.save(jax.tree.map(jnp.asarray, tree), str(tmp_path / "jax"), 6, extra={"who": "port"})
    import json
    manifests = [json.loads((d / "step_6" / "manifest.json").read_text())
                 for d in (tmp_path, tmp_path / "jax")]
    assert manifests[0] == manifests[1]


def test_resumed_training_matches_an_uninterrupted_run(tmp_path):
    """train(..., device="cpu") for 6 steps with a checkpoint every 3; then,
    with the final checkpoint removed, the same call resumes from step 3 and
    its 3 losses equal the uninterrupted run's last 3, bit for bit."""
    from repro_torch.launch.train import train
    kw = dict(reduced=True, steps=6, seq_len=16, global_batch=2, ckpt_every=3, log_every=0,
              device="cpu")
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    _, _, losses = train("qwen2-7b", ckpt_dir=full_dir, **kw)
    shutil.copytree(os.path.join(full_dir, "step_3"), os.path.join(part_dir, "step_3"))
    params, opt, resumed = train("qwen2-7b", ckpt_dir=part_dir, **kw)
    assert len(losses) == 6 and resumed == losses[3:]
    assert int(opt["step"]) == 6
    final = ck.restore(full_dir, 6, {"params": params, "opt": opt})
    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves({"params": params, "opt": opt}),
                    strict=True):
        assert torch.equal(a, b)
