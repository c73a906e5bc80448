"""The port's SSD scan and Mamba2 block on the CPU: the plain `ssd_scan`
(what `ssd_scan_op` runs for a CPU tensor) against the JAX Pallas kernel in
interpret mode, the JAX chunked reference and the sequential recurrence;
plus `ssd_step`, `mamba_apply` and `mamba_step` against JAX. Inputs are
drawn with numpy from a seed and fed to both frameworks. The CUDA kernel
runs only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.kernels.ssd_scan.kernel import ssd_scan as jx_scan
from repro.kernels.ssd_scan.ref import (ssd_scan_ref as jx_scan_ref,
                                        ssd_scan_sequential as jx_scan_seq)
from repro.models import ssd as jx_ssd
from repro.models.common import keygen, split_boxes
from repro_torch.models.common import split_boxes as tx_split_boxes
from repro_torch import kernels as tk
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import kernel as scan_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_sequential
from repro_torch.models import ssd as tx_ssd
from repro_torch.weights import from_jax

TOL = dict(atol=3e-4, rtol=3e-4)          # tests/test_kernels.py:237
F32 = dict(atol=5e-5, rtol=5e-5)          # tests/test_kernels.py:16
CFG = get_config("mamba2-2.7b-smoke")
JCFG = jx_get_config("mamba2-2.7b-smoke")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(seed, b, S, nh, hd, G, N):
    """The distributions of `tests/test_kernels.py::test_ssd_scan_sweep`,
    drawn with numpy: (x, dt, A, B, C, D) as f32 arrays."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, b, S, nh, hd)
    dt = (np.log1p(np.exp(_normal(rng, b, S, nh))) * 0.1).astype(np.float32)
    A = -np.exp(_normal(rng, nh))
    return (x, dt, A, _normal(rng, b, S, G, N), _normal(rng, b, S, G, N),
            _normal(rng, nh))


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", [
    # (b, S, nh, hd, G, N, chunk): tests/test_kernels.py:220-225
    (2, 64, 4, 8, 2, 16, 16),
    (1, 128, 2, 64, 1, 128, 32),
    (2, 96, 4, 16, 4, 32, 32),
    # exact-length prefill: one ragged chunk of 200, and a 1-token prompt
    (1, 200, 2, 16, 1, 16, 200),
    (2, 1, 4, 16, 2, 16, 1),
])
def test_ssd_scan_plain_matches_jax_kernel_and_oracles(shape):
    b, S, nh, hd, G, N, chunk = shape
    arrs = _inputs(0, b, S, nh, hd, G, N)
    y, h = ssd_scan_op(*_t(arrs), chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert tuple(h.shape) == (b, nh, hd, N)
    jy, jh = jx_scan(*_j(arrs), chunk=chunk, interpret=True)
    for want_y, want_h in ((jy, jh),
                           jx_scan_ref(*_j(arrs), chunk=chunk),
                           jx_scan_seq(*_j(arrs))):
        _close(y, want_y)
        _close(h, want_h)
    # the port's own oracles agree with its plain version
    sy, sh = ssd_scan_sequential(*_t(arrs))
    _close(y, sy.numpy())
    _close(h, sh.numpy())


def test_ssd_scan_padded_tail_with_dt_zero_is_an_identity():
    """mamba_apply pads S up to a chunk multiple with dt = 0: the tail
    must neither decay nor feed the state, whatever x, B and C hold."""
    b, S, pad, nh, hd, G, N, chunk = 1, 40, 8, 4, 16, 2, 16, 16
    arrs = _inputs(1, b, S + pad, nh, hd, G, N)
    x, dt, A, B, C, D = arrs
    dt = dt.copy()
    dt[:, S:] = 0.0
    y, h = ssd_scan_op(*_t((x, dt, A, B, C, D)), chunk=chunk)
    ry, rh = jx_scan_seq(*_j((x[:, :S], dt[:, :S], A, B[:, :S], C[:, :S],
                              D)))
    _close(y[:, :S], ry)
    _close(h, rh)


def test_ssd_scan_with_initial_state_matches_jax_chunked():
    """h0 (the hybrid family passes one): against JAX `ssd_chunked(h0=)`
    and the sequential recurrence from the same state."""
    b, S, nh, hd, G, N, chunk = 2, 48, 4, 16, 2, 32, 16
    arrs = _inputs(2, b, S, nh, hd, G, N)
    h0 = np.random.default_rng(3).standard_normal(
        (b, nh, hd, N)).astype(np.float32)
    y, h = ssd_scan_op(*_t(arrs), chunk=chunk,
                       h0=torch.from_numpy(h0.copy()))
    jy, jh = jx_ssd.ssd_chunked(*_j(arrs), chunk, h0=jnp.asarray(h0))
    _close(y, jy)
    _close(h, jh)
    sy, sh = jx_ssd.ssd_reference(*_j(arrs), h0=jnp.asarray(h0))
    _close(y, sy)
    _close(h, sh)
    ry, rh = ssd_scan_ref(*_t(arrs), chunk=chunk,
                          h0=torch.from_numpy(h0.copy()))
    _close(ry, jy)


def test_ssd_scan_op_bf16_inputs_compute_in_f32():
    """bf16 x, B, C, A, D (a bf16 model): y comes back bf16, h_final f32,
    both as JAX computes them from the same bf16 inputs."""
    b, S, nh, hd, G, N, chunk = 1, 64, 4, 16, 1, 32, 32
    x, dt, A, B, C, D = _inputs(4, b, S, nh, hd, G, N)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, A, B, C, D)]
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, A, B, C, D)]
    y, h = ssd_scan_op(tb[0], torch.from_numpy(dt), tb[1], tb[2], tb[3],
                       tb[4], chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jy, jh = jx_ssd.ssd_chunked(jb[0], jnp.asarray(dt), jb[1], jb[2], jb[3],
                                jb[4], chunk)
    _close(y, jy, dict(atol=3e-2, rtol=3e-2))     # one bf16 rounding of y
    _close(h, jh)


def test_ssd_scan_wrapper_refuses_cpu_tensors_without_counting():
    tk.reset_launch_counts()
    arrs = _t(_inputs(5, 1, 16, 2, 16, 1, 16))
    with pytest.raises(ValueError):
        scan_kernel.ssd_scan(*arrs, chunk=16)
    ssd_scan_op(*arrs, chunk=16)
    assert tk.launch_counts()["ssd_scan"] == 0


def test_ssd_step_matches_jax():
    b, nh, hd, G, N = 3, 4, 16, 2, 16
    rng = np.random.default_rng(6)
    h = _normal(rng, b, nh, hd, N)
    args = (_normal(rng, b, nh, hd), np.abs(_normal(rng, b, nh)) * 0.1,
            -np.exp(_normal(rng, nh)), _normal(rng, b, G, N),
            _normal(rng, b, G, N), _normal(rng, nh))
    th, ty = tx_ssd.ssd_step(torch.from_numpy(h), *_t(args))
    jh, jy = jx_ssd.ssd_step(jnp.asarray(h), *_j(args))
    _close(th, jh, F32)
    _close(ty, jy, F32)


@pytest.fixture(scope="module")
def block():
    """One Mamba2 block's params at the smoke width: JAX init, carried
    over."""
    jp, _ = split_boxes(jx_ssd.mamba_params(keygen(jax.random.PRNGKey(0)),
                                            JCFG))
    return jp, from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("S", [1, 16, 37])
def test_mamba_apply_matches_jax(block, S):
    """Full-sequence block: output, final SSM state and conv state. S = 37
    pads to 48 (chunk 16) with dt = 0."""
    jp, tp = block
    x = np.random.default_rng(S).standard_normal(
        (2, S, CFG.d_model)).astype(np.float32)
    jy, (jh, jc) = jx_ssd.mamba_apply(jp, jnp.asarray(x), JCFG)
    ty, (th, tc) = tx_ssd.mamba_apply(tp, torch.from_numpy(x), CFG)
    _close(ty, jy, F32)
    _close(th, jh, F32)
    for k in ("x", "B", "C"):
        _close(tc[k], jc[k], F32)


def test_mamba_step_continues_mamba_apply_like_jax(block):
    """Prefill 12 tokens, then 3 decode steps from its state."""
    jp, tp = block
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 15, CFG.d_model)).astype(np.float32)
    _, jstate = jx_ssd.mamba_apply(jp, jnp.asarray(x[:, :12]), JCFG)
    _, tstate = tx_ssd.mamba_apply(tp, torch.from_numpy(x[:, :12]), CFG)
    for t in range(12, 15):
        jy, jstate = jx_ssd.mamba_step(jp, jnp.asarray(x[:, t]), JCFG,
                                       jstate)
        ty, tstate = tx_ssd.mamba_step(tp, torch.from_numpy(x[:, t]), CFG,
                                       tstate)
        _close(ty, jy, F32)
    _close(tstate[0], jstate[0], F32)
    for k in ("x", "B", "C"):
        _close(tstate[1][k], jstate[1][k], F32)


def test_mamba_params_layout_and_deterministic_leaves(block):
    """Same tree and shapes as the JAX init; A_log is the same
    deterministic vector; dt_bias is the inverse softplus of a draw in
    [0.001, 0.1]."""
    jp, _ = block
    tp, _ = tx_split_boxes(tx_ssd.mamba_params(
        torch.Generator().manual_seed(0), CFG, device="cpu"))
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6)             # log: 1 ulp apart
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 0.001 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    stacked, _ = tx_split_boxes(tx_ssd.mamba_params(
        torch.Generator().manual_seed(0), CFG, device="cpu", stack=3))
    assert tuple(stacked["wx"].shape) == (3,) + jp["wx"].shape
    assert tuple(stacked["A_log"].shape) == (3,) + jp["A_log"].shape
