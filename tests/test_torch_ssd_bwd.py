"""The gradient of the port's SSD scan on the CPU against JAX.

`ssd_scan_op` on inputs that require grad runs as `SsdScan`; on the CPU its
backward is `ssd_scan_bwd_ref`. Its gradients (dx, ddt, dA, dB, dC, dD,
dh0) are held against `jax.vjp` of the jnp `repro.models.ssd.ssd_chunked`,
the function the JAX train step differentiates, on the same numpy inputs.
The kernel's own decomposition (`csrc/ssd_scan_bwd.cu`: chunk state
gradients, reverse state passing, the source and query sides of each chunk
by head blocks, the scan of d a_cum, fixed-order sums), written out in
PyTorch as `ssd_scan_bwd_split_ref`, is held to the same reference, so
the formula the card runs is checked here too.

Tolerance: each gradient within 5e-5 of its largest |value| in f32 (the
f32 figure of `tests/test_kernels.py:16`); with bf16 x, B, C and dy,
within 3e-2 of it (the bf16 figure there: both sides compute in f32 and
round dx, dB and dC to bf16 once, one ulp being 2^-8 of a value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssd import ssd_chunked as jx_ssd_chunked
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.kernel import ssd_bwd_plan
from repro_torch.kernels.ssd_scan.ops import SsdScan, ssd_scan_op

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
BOUND = {"float32": 5e-5, "bfloat16": 3e-2}
b_, nh_, hd_, N_, Q_ = 2, 4, 8, 16, 16


def _inputs(seed, S, G, with_h0, with_dh, *, b=b_, nh=nh_, hd=hd_, N=N_):
    """x, dt, A, B, C, D, h0, dy, dh_final as f32 numpy arrays, with the
    distributions of the JAX kernel sweep (h0, dh_final None where not
    asked for)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x, B, C = n(b, S, nh, hd), n(b, S, G, N), n(b, S, G, N)
    dt = (np.log1p(np.exp(n(b, S, nh))) * 0.1).astype(np.float32)
    A, D = -np.exp(n(nh)), n(nh)
    h0 = n(b, nh, hd, N) if with_h0 else None
    dy = n(b, S, nh, hd)
    dh = n(b, nh, hd, N) if with_dh else None
    return x, dt, A, B, C, D, h0, dy, dh


def _jax_vjp(chunk, with_h0, args):
    """(inputs, dy, dh) -> the vjp of ssd_chunked, lowered and compiled
    once a shape at XLA's lowest optimisation level (the compile, not the
    run, is the cost at these sizes); dh is always given (zeros where the
    test has none)."""
    key = (chunk, with_h0) + tuple((a.shape, str(a.dtype)) for a in args)
    if key not in _COMPILED:
        def f(x, dt, A, B, C, D, h0, dy, dh):
            def fwd(x, dt, A, B, C, D, h0):
                return jx_ssd_chunked(x, dt, A, B, C, D, chunk,
                                      h0=h0 if with_h0 else None)
            (y, h), vjp = jax.vjp(fwd, x, dt, A, B, C, D, h0)
            return vjp((dy.astype(y.dtype), dh))
        _COMPILED[key] = jax.jit(f).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    return _COMPILED[key]


_COMPILED = {}


def _jax_grads(arrs, chunk, dtype):
    x, dt, A, B, C, D, h0, dy, dh = arrs
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    b, S, nh, hd = x.shape
    N = B.shape[3]
    zeros = np.zeros((b, nh, hd, N), np.float32)
    args = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jd), jnp.asarray(C, jd), jnp.asarray(D),
            jnp.asarray(zeros if h0 is None else h0), jnp.asarray(dy, jd),
            jnp.asarray(zeros if dh is None else dh))
    g = _jax_vjp(chunk, h0 is not None, args)(*args)
    return [np.asarray(t, np.float32) for t in g[:6]] + \
        [np.asarray(g[6], np.float32) if h0 is not None else None]


def _port_grads(arrs, chunk, dtype):
    """ssd_scan_op on the CPU, through SsdScan, differentiated by autograd
    for dy (and dh_final where given)."""
    x, dt, A, B, C, D, h0, dy, dh = arrs

    def leaf(a, dt_=torch.float32):
        return torch.from_numpy(a).to(dt_).requires_grad_(True)
    ins = [leaf(x, dtype), leaf(dt), leaf(A), leaf(B, dtype), leaf(C, dtype),
           leaf(D)]
    h0_t = None if h0 is None else leaf(h0)
    y, h = ssd_scan_op(*ins, chunk=chunk, h0=h0_t)
    assert y.grad_fn is not None and y.grad_fn.name().startswith("SsdScan")
    outs, cots = [y], [torch.from_numpy(dy).to(dtype)]
    if dh is not None:
        outs.append(h)
        cots.append(torch.from_numpy(dh))
    leaves = ins + ([h0_t] if h0_t is not None else [])
    g = torch.autograd.grad(outs, leaves, cots)
    for t, gi in zip(leaves, g):
        assert gi.dtype == t.dtype and gi.shape == t.shape
    out = [t.float().numpy() for t in g]
    return out[:6] + [out[6] if h0 is not None else None]


def _close(got, want, dtype_name, what=""):
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= BOUND[dtype_name] * scale, (what, name, err, scale)


@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_op_grads_match_jax_vjp(G, with_h0, with_dh, n_chunks):
    """f32, over G = 1 and G = 2 (two heads a group), h0 given or None,
    dh_final zero (the loss ignores h_final) or not, 1 and 3 chunks."""
    arrs = _inputs(10 * G + 2 * with_h0 + with_dh + n_chunks,
                   Q_ * n_chunks, G, with_h0, with_dh)
    _close(_port_grads(arrs, Q_, torch.float32),
           _jax_grads(arrs, Q_, torch.float32), "float32")


def test_ssd_scan_op_grads_match_jax_vjp_bf16():
    """bf16 x, B, C and dy (A, D, dt, h0 f32, as the kernel takes them),
    two groups, h0 and dh_final given, 3 chunks."""
    arrs = _inputs(99, 3 * Q_, 2, True, True)
    _close(_port_grads(arrs, Q_, torch.bfloat16),
           _jax_grads(arrs, Q_, torch.bfloat16), "bfloat16")


def test_padded_tail_passes_the_gradient_through():
    """The model pads a prompt to a whole chunk with dt = 0 steps (x, B, C
    zero there). Those steps are identities in the backward too: the
    state gradient crosses them unchanged, so with dh_final given the
    gradients of the real rows, dA, dD and dh0 equal those of the unpadded
    scan (JAX's vjp over the 40 real rows in chunks of 8), whatever dy is
    on the padded rows."""
    S, pad, G = 40, 8, 2
    arrs = _inputs(7, S, G, True, True)
    x, dt, A, B, C, D, h0, dy, dh = arrs
    rng = np.random.default_rng(8)

    def padded(a, fill=0.0):
        tail = np.full((a.shape[0], pad) + a.shape[2:], fill, np.float32)
        return np.concatenate([a, tail], axis=1)
    dy_p = np.concatenate(
        [dy, rng.standard_normal((b_, pad, nh_, hd_)).astype(np.float32)], 1)
    got = _port_grads((padded(x), padded(dt), A, padded(B), padded(C), D,
                       h0, dy_p, dh), 16, torch.float32)
    want = _jax_grads(arrs, 8, torch.float32)
    real = [g[:, :S] if g.ndim >= 3 and g.shape[1] == S + pad else g
            for g in got]
    _close(real, want, "float32", "padded")


# ---------------------------------------------------------------------------
# the kernel's decomposition (`ssd_scan_bwd_split_ref`) against the same
# reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (S, chunk, G, h0, dh_final, nh, hd, N, SMs, heads a block)
    (48, 16, 2, True, True, 4, 8, 16, 132, 1),
    (36, 12, 1, False, True, 4, 8, 16, 132, 1),   # a chunk not a power of 2
    (32, 32, 4, True, False, 4, 8, 16, 132, 1),   # one chunk, a head a group
    # head blocks of 4, 2 and 1 heads of a group (G = 2), a chunk of 100
    # rows (a 64-row tile and a ragged 36-row one)
    (200, 100, 2, True, True, 8, 16, 32, 16, 4),
    (200, 100, 2, False, True, 8, 8, 16, 32, 2),
    (200, 100, 2, True, False, 8, 32, 32, 64, 1),
    (130, 130, 2, True, True, 8, 16, 32, 4, 4),   # one chunk, 3 tiles
])
def test_kernel_decomposition_matches_jax_vjp(case):
    """`ssd_scan_bwd_split_ref` (the seven launches of
    `csrc/ssd_scan_bwd.cu`, head blocks from `ssd_bwd_plan` for the given
    SM count) against jax.vjp in f32."""
    S, chunk, G, with_h0, with_dh, nh, hd, N, sms, hb = case
    assert ssd_bwd_plan(b_, S, nh, hd, G, N, chunk,
                        sms).heads_per_block == hb
    arrs = _inputs(S + G, S, G, with_h0, with_dh, nh=nh, hd=hd, N=N)
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    x, dt, A, B, C, D, h0, dy, dh = t
    got = ssd_ref.ssd_scan_bwd_split_ref(x, dt, A, B, C, D, dy, dh,
                                         chunk=chunk, h0=h0, sm_count=sms)
    got = [g.numpy() for g in got[:6]] + \
        [got[6].numpy() if h0 is not None else None]
    _close(got, _jax_grads(arrs, chunk, torch.float32), "float32")


def test_kernel_decomposition_bf16_inputs():
    """bf16 x, B, C and dy through the decomposition (f32 arithmetic, dx,
    dB and dC rounded once to bf16) against jax.vjp on the same bf16
    inputs, within the bf16 bound."""
    arrs = _inputs(98, 3 * Q_, 2, True, True)
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    x, dt, A, B, C, D, h0, dy, dh = t
    bf = torch.bfloat16
    got = ssd_ref.ssd_scan_bwd_split_ref(x.to(bf), dt, A, B.to(bf),
                                         C.to(bf), D, dy.to(bf), dh,
                                         chunk=Q_, h0=h0)
    assert got[0].dtype == got[3].dtype == got[4].dtype == bf
    got = [g.float().numpy() for g in got]
    _close(got, _jax_grads(arrs, Q_, bf), "bfloat16")


def test_plain_bwd_and_function_agree():
    """`ssd_scan_bwd_ref` called directly gives SsdScan's CPU gradients to
    the bit (the Function adds nothing on the CPU), and a dh_final of None
    equals zeros."""
    arrs = _inputs(3, 32, 2, True, False)
    x, dt, A, B, C, D, h0, dy, _ = [None if a is None else torch.from_numpy(a)
                                    for a in arrs]
    direct = ssd_ref.ssd_scan_bwd_ref(x, dt, A, B, C, D, dy, None, chunk=16,
                                      h0=h0)
    zeros = ssd_ref.ssd_scan_bwd_ref(x, dt, A, B, C, D, dy,
                                     torch.zeros_like(h0), chunk=16, h0=h0)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, D, h0)]
    y, _ = SsdScan.apply(*ins, 16, False)
    via = torch.autograd.grad(y, ins, dy)
    for a, b, c in zip(direct, zeros, via):
        assert torch.equal(a, c) and torch.equal(a, b)
