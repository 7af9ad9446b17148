"""Kernel K2's plain PyTorch twin against the JAX normal-equation assembly
(CPU).

In f64 against `assemble_normal_eq_reference` (1e-12 relative: the same
products summed in another order).  With f32=True against the Pallas
kernel run in interpret mode, which casts its inputs to f32 and sums in
f32, at tests/test_kernels.py's tolerances for that kernel (rtol 1e-5,
atol 1e-6).  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vinsat_tpu.kernels import normal_eq as jne
from vinsat_tpu_torch.kernels import normal_eq as ne

from torch_parity import rel_err


def _case(seed, N=13, D=4):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(N, D, 2, 9))
    r = rng.normal(size=(N, D, 2))
    w = rng.random((N, D))
    w[::3, -1] = 0.0  # empty observation slots
    return J, r, w


@pytest.mark.parametrize("seed,D", [(0, 4), (1, 1), (2, 7)])
def test_plain_matches_reference_f64(seed, D):
    J, r, w = _case(seed, D=D)
    G_ref, g_ref = jne.assemble_normal_eq_reference(
        jnp.asarray(J), jnp.asarray(r), jnp.asarray(w))
    G, g = ne.assemble_normal_eq_plain(*(torch.as_tensor(a)
                                         for a in (J, r, w)))
    assert G.dtype == g.dtype == torch.float64
    assert G.shape == (13, 9, 9) and g.shape == (13, 9)
    assert rel_err(G, G_ref) < 1e-12
    assert rel_err(g, g_ref) < 1e-12


def test_plain_f32_matches_pallas_interpret():
    J, r, w = _case(3)
    G_ref, g_ref = jne.assemble_normal_eq(
        jnp.asarray(J), jnp.asarray(r), jnp.asarray(w), interpret=True)
    G, g = ne.assemble_normal_eq_plain(
        *(torch.as_tensor(a) for a in (J, r, w)), f32=True)
    assert G.dtype == torch.float64  # cast back, as the JAX kernel does
    np.testing.assert_allclose(G.numpy(), np.asarray(G_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-6)


def test_wrapper_runs_plain_on_cpu():
    J, r, w = (torch.as_tensor(a) for a in _case(4))
    before = ne.assemble_normal_eq.launches
    for f32 in (False, True):
        G, g = ne.assemble_normal_eq(J, r, w, f32=f32)
        G_p, g_p = ne.assemble_normal_eq_plain(J, r, w, f32=f32)
        assert torch.equal(G, G_p) and torch.equal(g, g_p)
    assert ne.assemble_normal_eq.launches == before


@pytest.mark.parametrize("bad,err", [
    (lambda J, r, w: (J[..., :8], r, w), ValueError),
    (lambda J, r, w: (J, r[:, :-1], w), ValueError),
    (lambda J, r, w: (J, r, w[:-1]), ValueError),
    (lambda J, r, w: (J, r.float(), w), TypeError),
    (lambda J, r, w: (J.long(), r.long(), w.long()), TypeError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    args = bad(*(torch.as_tensor(a) for a in _case(5)))
    with pytest.raises(err):
        ne.assemble_normal_eq(*args)
