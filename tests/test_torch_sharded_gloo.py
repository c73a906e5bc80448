"""The shard-local cores of `models/sharded.py` and a sharded train step
on a real 4-rank `gloo` process group on the CPU
(`tests/torch_sharded_worker.py`, one subprocess for the module), where
collectives move data, against the JAX package's oracles:

  * `flash_prefill` on (2, 2) and (1, 4) data x model meshes against
    `flash_reference`, the (1, 4) case with kv heads that do not divide
    the model axis (each rank reads the kv head of its q heads);
  * `ssd_scan` against `ssd_chunked`, the B/C groups narrowed to each
    rank's heads;
  * `decode_attend` against JAX's `decode_attend` over a cache sharded
    along its sequence (`combine_seq_shards`, the flash-decoding combine
    the card's core shares), the new row written in place first, also
    with ranks that hold no live key;
  * yi-6b-smoke's loss and gradients with params, batch and step sharded
    by the train rules against the same on plain tensors (the debug mesh),
    and one step of the launcher's `_sharded_step` against one debug step.

Tolerance f32 5e-5 (`tests/test_kernels.py:16`) for the cores; for the
train step the bounds of `tests/test_torch_training.py` at standard
attention scales: the loss within 1e-5 relative, each gradient leaf
within 5e-5 of its largest entry, each param after one AdamW step within
2 x the step's learning rate (Adam's first update is about lr x sign(g),
so a near-zero gradient whose sign differs may move a param that far).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.attention import decode_attend as jx_decode_attend
from repro.models.attention import flash_reference
from repro.models.ssd import ssd_chunked
from repro_torch.training.optimizer import AdamWConfig
from torch_sharded_worker import run_worker

F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16

# (B, S, H, Hkv, hd) of the attention cases
FLASH = {"a": (2, 32, 4, 2, 16), "b": (2, 32, 4, 2, 16),
         "c": (1, 32, 8, 2, 16)}
FLASH_WINDOW = {"a": 0, "b": 8, "c": 0}
# (b, S, nh, hd, G, N) of the scan cases
SSD = {"a": (2, 32, 4, 8, 2, 8), "b": (1, 32, 8, 8, 2, 8)}
# (B, Smax, H, Hkv, hd, pos) of the decode cases
# c: Smax 4 ways over a (1, 4) mesh; sequence 0's keys all on rank 0
# (ranks 1-3 hold no live key), sequence 1's new row on rank 2, rank 3 empty
DECODE = {"a": (1, 16, 4, 2, 8, [10]), "b": (2, 16, 4, 1, 8, [5, 19]),
          "c": (2, 16, 4, 2, 8, [2, 9])}
DECODE_SOFTCAP = {"a": 0.0, "b": 30.0, "c": 0.0}


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    d = {}
    for c, (B, S, H, Hkv, hd) in FLASH.items():
        d[f"fl_{c}_q"], d[f"fl_{c}_k"], d[f"fl_{c}_v"] = \
            f(B, S, H, hd), f(B, S, Hkv, hd), f(B, S, Hkv, hd)
    for c, (b, S, nh, hd, G, N) in SSD.items():
        d.update({f"ssd_{c}_x": f(b, S, nh, hd),
                  f"ssd_{c}_dt": rng.uniform(0.01, 0.2, (b, S, nh))
                  .astype(np.float32),
                  f"ssd_{c}_A": -rng.uniform(0.5, 2.0, nh).astype(np.float32),
                  f"ssd_{c}_B": f(b, S, G, N), f"ssd_{c}_C": f(b, S, G, N),
                  f"ssd_{c}_D": f(nh), f"ssd_{c}_h0": f(b, nh, hd, N)})
    for c, (B, Smax, H, Hkv, hd, pos) in DECODE.items():
        pos = np.array(pos, np.int32)
        d.update({f"dec_{c}_q": f(B, H, hd),
                  f"dec_{c}_kc": f(B, Smax, Hkv, hd),
                  f"dec_{c}_vc": f(B, Smax, Hkv, hd),
                  f"dec_{c}_kn": f(B, Hkv, hd), f"dec_{c}_vn": f(B, Hkv, hd),
                  # a full cache writes at lens - 1, a ring at pos % Smax
                  f"dec_{c}_lens": np.minimum(pos + 1, Smax).astype(np.int32),
                  f"dec_{c}_slot": (pos % Smax).astype(np.int32)})
    rng_t = np.random.default_rng(1)
    d["train_arch"] = np.array("yi-6b-smoke")
    d["train_tokens"] = rng_t.integers(0, 256, (4, 16)).astype(np.int32)
    d["train_targets"] = rng_t.integers(0, 256, (4, 16)).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    proc = run_worker(tmp / "in.npz", tmp / "out.npz", "cores,train")
    assert proc.wait(timeout=600) == 0
    return d, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("case", sorted(FLASH))
def test_sharded_flash_prefill_equals_jax(run, case):
    d, out = run
    want = flash_reference(*(jnp.asarray(d[f"fl_{case}_{n}"]) for n in "qkv"),
                           causal=True, window=FLASH_WINDOW[case],
                           block_q=16, block_kv=16)
    np.testing.assert_allclose(out[f"fl_{case}"], np.asarray(want), **F32)


@pytest.mark.parametrize("case", sorted(SSD))
def test_sharded_ssd_scan_equals_jax(run, case):
    d, out = run
    args = [jnp.asarray(d[f"ssd_{case}_{n}"])
            for n in ("x", "dt", "A", "B", "C", "D")]
    y, h = ssd_chunked(*args, 8, h0=jnp.asarray(d[f"ssd_{case}_h0"]))
    np.testing.assert_allclose(out[f"ssd_{case}_y"], np.asarray(y), **F32)
    np.testing.assert_allclose(out[f"ssd_{case}_h"], np.asarray(h), **F32)


@pytest.mark.parametrize("case", sorted(DECODE))
def test_sharded_decode_attend_on_a_sequence_sharded_cache_equals_jax(
        run, case):
    d, out = run
    # the cache is sharded along Smax (tensor dim 1) on some mesh dim
    assert "Shard(dim=1)" in list(out[f"dec_{case}_placements"])
    B = d[f"dec_{case}_q"].shape[0]
    kc, vc = d[f"dec_{case}_kc"].copy(), d[f"dec_{case}_vc"].copy()
    slot = d[f"dec_{case}_slot"]
    kc[np.arange(B), slot] = d[f"dec_{case}_kn"]
    vc[np.arange(B), slot] = d[f"dec_{case}_vn"]
    np.testing.assert_array_equal(out[f"dec_{case}_kc"], kc)
    np.testing.assert_array_equal(out[f"dec_{case}_vc"], vc)
    want = jx_decode_attend(
        jnp.asarray(d[f"dec_{case}_q"]), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(d[f"dec_{case}_lens"]),
        logit_softcap=DECODE_SOFTCAP[case])
    np.testing.assert_allclose(out[f"dec_{case}"], np.asarray(want), **F32)


def test_sharded_train_step_equals_the_debug_step(run):
    """The loss and every gradient leaf, then one AdamW step's loss,
    gradient norm and updated params; every op of the sharded step had a
    DTensor sharding strategy (no replicated fallback)."""
    _, out = run
    assert list(out["train_fallbacks"]) == [""]
    np.testing.assert_allclose(out["train_total_sharded"],
                               out["train_total_plain"], rtol=1e-5)
    names = [k.split("/", 1)[1] for k in out
             if k.startswith("train_grad_plain/")]
    assert len(names) > 10
    for n in names:
        want = out[f"train_grad_plain/{n}"]
        err = np.abs(out[f"train_grad_sharded/{n}"] - want).max()
        assert err <= 5e-5 * np.abs(want).max(), (n, err)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(out[f"train_step_{k}_sharded"],
                                   out[f"train_step_{k}_plain"], rtol=1e-5)
    lr = AdamWConfig().lr / AdamWConfig().warmup_steps   # step 1's
    for n in names:
        np.testing.assert_allclose(out[f"train_step_param_sharded/{n}"],
                                   out[f"train_step_param_plain/{n}"],
                                   rtol=0, atol=2 * lr, err_msg=n)
