"""Checkpoints across the two packages, and the port's training launcher
on the CPU.

A checkpoint the JAX package writes restores in the port, and one the
port writes restores in JAX, leaf for leaf to the bit: with msgpack and
zstd where installed, and with both packages' fallbacks (JSON index,
zlib) when `msgpack` and `zstd` are patched to None on both sides. The
trees hold f32 params, the AdamW state with its int32 `step` scalar and
one bf16 leaf.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jx_ckpt
from repro_torch.launch import train as launch_train
from repro_torch.training import checkpoint as ckpt

CODECS = ["native", "fallback"]


def _trees(seed=0):
    """The same params and opt state as numpy: nested dicts with a stacked
    f32 leaf, a vector, a bf16 leaf (as f32 values that bf16 holds
    exactly) and the int32 step scalar. Keys in sorted order, the order
    of a dict that `jax.tree.map` returns, so both packages write the
    index's leaves in one order."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"embed": f32(11, 8),
              "half": f32(3, 5).astype(jnp.bfloat16).astype(np.float32),
              "seg0": {"attn": {"wq": f32(2, 8, 2, 4)},
                       "ln1": {"w": f32(2, 8)}}}
    opt = {"m": {k: v for k, v in params.items()},
           "step": np.int32(7),
           "v": {"embed": f32(11, 8), "half": params["half"],
                 "seg0": params["seg0"]}}
    return params, opt


def _jax(tree):
    def leaf(path, x):
        half = getattr(path[-1], "key", None) == "half"
        return jnp.asarray(x, jnp.bfloat16 if half else None)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _torch(tree):
    def rec(node, name=""):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))
        return t.to(torch.bfloat16) if name == "half" else t
    return rec(tree)


def _codec(monkeypatch, codec):
    if codec == "fallback":
        for mod in (jx_ckpt, ckpt):
            monkeypatch.setattr(mod, "msgpack", None)
            monkeypatch.setattr(mod, "zstd", None)


def _same(t, j):
    """A restored torch leaf equals a JAX leaf, dtype and bits."""
    j = np.asarray(j)
    if str(j.dtype) == "bfloat16":
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32))
    else:
        assert str(t.numpy().dtype) == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), j)


def _flat(tree):
    return ckpt._flatten(tree)


@pytest.mark.parametrize("codec", CODECS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, monkeypatch, codec):
    _codec(monkeypatch, codec)
    params, opt = _trees()
    jp, jo = _jax(params), _jax(opt)
    jx_ckpt.save(str(tmp_path / "step_7"), 7, jp, jo, extra={"k": 1})
    step, tp, to, extra = ckpt.restore(str(tmp_path / "step_7"),
                                       _torch(params), _torch(opt))
    assert step == 7 and extra == {"k": 1}
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert to["step"].dtype == torch.int32 and to["step"].dim() == 0
    for tree_t, tree_j in ((tp, jp), (to, jo)):
        ft, fj = _flat(tree_t), _flat(tree_j)
        assert ft.keys() == fj.keys()
        for k in ft:
            _same(ft[k], fj[k])


@pytest.mark.parametrize("codec", CODECS)
def test_port_checkpoint_restores_in_jax(tmp_path, monkeypatch, codec):
    _codec(monkeypatch, codec)
    params, opt = _trees(1)
    tp, to = _torch(params), _torch(opt)
    ckpt.save(str(tmp_path / "step_3"), 3, tp, to)
    step, jp, jo, _ = jx_ckpt.restore(str(tmp_path / "step_3"),
                                      _jax(params), _jax(opt))
    assert step == 3
    assert jx_ckpt.latest_step(str(tmp_path)) == 3
    for tree_t, tree_j in ((tp, jp), (to, jo)):
        ft, fj = _flat(tree_t), _flat(tree_j)
        for k in ft:
            _same(ft[k], fj[k])


@pytest.mark.parametrize("codec", CODECS)
def test_port_writes_the_jax_files_byte_for_byte(tmp_path, monkeypatch,
                                                 codec):
    """The same trees saved by both packages give the same files: leaf
    files and the index, byte for byte."""
    _codec(monkeypatch, codec)
    params, opt = _trees(2)
    jx_ckpt.save(str(tmp_path / "jax"), 5, _jax(params), _jax(opt))
    ckpt.save(str(tmp_path / "port"), 5, _torch(params), _torch(opt))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_restore_refuses_mesh_shardings(tmp_path):
    params, opt = _trees()
    ckpt.save(str(tmp_path / "step_1"), 1, _torch(params))
    with pytest.raises(NotImplementedError, match="A15"):
        ckpt.restore(str(tmp_path / "step_1"), _torch(params),
                     shardings={"embed": None})


def _cli(argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main()
    return out.getvalue().splitlines()


def test_launcher_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """`python -m repro_torch.launch.train --device cpu`: 6 steps with a
    checkpoint every 3, then a second run to step 8 resumes from step 6;
    its losses equal a straight 8-step run's (the stream and the state
    resume exactly). The log lines are the JAX launcher's."""
    common = ["--arch", "yi-6b-smoke", "--batch", "4", "--seq", "32",
              "--device", "cpu"]
    ck = str(tmp_path / "ck")
    first = _cli(common + ["--steps", "6", "--ckpt-dir", ck,
                           "--ckpt-every", "3"], monkeypatch)
    assert first[3] == "[train] checkpointed step 3"
    assert first[-1] == "[train] checkpointed step 6"
    assert ckpt.latest_step(ck) == 6
    second = _cli(common + ["--steps", "8", "--ckpt-dir", ck], monkeypatch)
    assert second[0] == "[train] resumed from step 6"
    straight = _cli(common + ["--steps", "8"], monkeypatch)

    def losses(lines):
        return {ln.split()[2]: ln.split()[4] for ln in lines
                if ln.startswith("[train] step ")}
    assert losses(second) == {k: v for k, v in losses(straight).items()
                              if int(k) >= 6}
    assert {k: v for k, v in losses(first).items()} == \
        {k: v for k, v in losses(straight).items() if int(k) < 6}


def test_launcher_refuses_production_meshes_and_a_missing_card(monkeypatch):
    # a production mesh needs a process group of its 256 ranks (as JAX's
    # needs 256 devices); with none initialized the launcher refuses it
    with pytest.raises(RuntimeError, match="process group"):
        launch_train.run("yi-6b-smoke", 1, 2, 8, None, 0, mesh_kind="pod1",
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.run("yi-6b-smoke", 1, 2, 8, None, 0)
