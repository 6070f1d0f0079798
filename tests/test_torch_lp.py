"""K3, the LP relaxation: the port's closed-form gradient and the `lp_relax`
wrapper, on the CPU.

The closed-form gradient (`score_kernel.lp_gradient`, the arithmetic of both
the plain version and the CUDA kernel csrc/lp_relax.cu) is held against two
oracles: torch.autograd on the port's `lp_objective` (in float64) and
jax.grad on the reference's. The problems carry infeasible cells, padded
types and a zero-count group. The whole relaxation is held against the reference's
`lp_relax_body` by tests/test_torch_kernels.py; the kernel against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.ops import pallas_kernels
from karpenter_tpu.ops import score_kernel as ref_score
from karpenter_tpu_torch.ops import score_kernel as port_score

from tests.test_torch_kernels import LP_SEEDS, _lp_problem

torch.set_num_threads(2)

# The gradients agree to a few float32 ulps relative to the largest entry of
# the gradient: entries of the softmax backward S * (dS - sum S * dS) come
# out of a cancellation, and one far smaller than the largest keeps only the
# absolute error of the terms it was taken from. autograd is asked in
# float64, where it is exact to this tolerance: in float32 its logsumexp
# backward, exp(a - logsumexp(a)), carries the rounding of logsumexp(a) at
# |a| ~ 20 * nodes and lands up to 2.3e-4 of the scale away from the float64
# gradient on these problems, while the closed form and jax.grad (softmax
# form, the maximum subtracted exactly) stay within 6e-6 of it.
GRAD_RTOL = 1e-5


def _gradient_problem(seed, prices_kind):
    """A seeded LP state: the relaxation's inputs plus random logits. Padded
    types carry either their dominance price (finite, what the fused solve
    passes) or the raw +inf price, whose p * w / K terms are inf or NaN until
    a select drops them."""
    vectors, counts, capacity, _, valid, prices = _lp_problem(seed)
    # Two padded types past the real ones, as the bucket padding adds them.
    capacity = np.pad(capacity, ((0, 2), (0, 0)))
    valid = np.pad(valid, (0, 2))
    prices = np.pad(prices, (0, 2), constant_values=np.inf)
    counts = counts.copy()
    counts[0] = 0  # a real group with no pods left
    # A group as large as the widest type fits only the types that dominate
    # it: the others are infeasible cells.
    vectors = vectors.copy()
    vectors[1] = capacity[int(np.argmax(np.where(valid, capacity[:, 0], -1.0)))]
    raw = np.where(valid, prices, np.inf).astype(np.float32)
    if prices_kind == "effective":
        prices = np.asarray(pallas_kernels._dominance_prices_ref(capacity, raw)).astype(np.float32)
    else:
        prices = raw
    rng = np.random.default_rng(100 + seed)
    logits = rng.normal(0.0, 2.0, (vectors.shape[0], capacity.shape[0])).astype(np.float32)
    return logits, vectors, counts.astype(np.float32), capacity, prices, valid


def _port_feasible(vectors, capacity, valid):
    return port_score.feasibility_mask(
        torch.from_numpy(vectors), torch.from_numpy(capacity), torch.from_numpy(valid)
    )


@pytest.mark.parametrize("prices_kind", ["effective", "raw"])
@pytest.mark.parametrize("seed", LP_SEEDS)
def test_closed_form_gradient_matches_autograd_and_jax(seed, prices_kind):
    logits, vectors, counts, capacity, prices, valid = _gradient_problem(seed, prices_kind)
    feasible = _port_feasible(vectors, capacity, valid)
    assert not bool(feasible[:, valid].all()), "the problem should hold infeasible cells"
    assert not bool(valid.all()), "the problem should hold padded types"
    args = [torch.from_numpy(a) for a in (vectors, counts, capacity, prices)]

    got = port_score.lp_gradient(torch.from_numpy(logits), *args, feasible).numpy()

    leaf = torch.from_numpy(logits.astype(np.float64)).requires_grad_(True)
    (by_autograd,) = torch.autograd.grad(
        port_score.lp_objective(leaf, *(arg.double() for arg in args), feasible), leaf
    )
    by_jax = jax.grad(ref_score.lp_objective)(
        jnp.asarray(logits), vectors, counts, capacity, prices, np.asarray(feasible.numpy())
    )

    assert np.isfinite(got).all()
    scale = float(np.abs(got).max())
    assert scale > 0
    for oracle in (by_autograd.numpy(), np.asarray(by_jax)):
        np.testing.assert_allclose(got, oracle, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)
    # Masked cells get exactly zero, and so does the zero-count group.
    assert (got[~feasible.numpy()] == 0).all()
    assert (got[0] == 0).all()


def test_bias_corrections_are_optax_constants():
    table = port_score.bias_corrections(300)
    assert table.shape == (300, 2) and table.dtype == np.float32
    for k in (1, 2, 7, 300):
        assert table[k - 1, 0] == np.float32(1.0) - np.float32(0.9) ** np.float32(k)
        assert table[k - 1, 1] == np.float32(1.0) - np.float32(0.999) ** np.float32(k)
    assert port_score.bias_corrections(0).shape == (0, 2)


def _lp_args(seed=0):
    vectors, counts, capacity, _, valid, prices = _lp_problem(seed)
    effective = np.asarray(
        pallas_kernels._dominance_prices_ref(capacity, np.where(valid, prices, np.inf))
    ).astype(np.float32)
    return [torch.from_numpy(a) for a in (vectors, counts, capacity, valid, effective)]


@pytest.mark.parametrize("steps", [0, 1, 300])
def test_lp_relax_routes_cpu_tensors_to_the_plain_version(steps):
    args = _lp_args()
    before = port_score.lp_relax.launches
    got = port_score.lp_relax(*args, steps=steps)
    want = port_score.lp_relax_body(*args, steps=steps)
    assert port_score.lp_relax.launches == before  # no kernel launch on the CPU
    for field, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), field


def _replace(args, index, value):
    args = list(args)
    args[index] = value
    return args


BAD_ARGS = {
    "vectors-f64": (lambda a: _replace(a, 0, a[0].double()), TypeError),
    "counts-f32": (lambda a: _replace(a, 1, a[1].float()), TypeError),
    "valid-u8": (lambda a: _replace(a, 3, a[3].to(torch.uint8)), TypeError),
    "prices-short": (lambda a: _replace(a, 4, a[4][:-1]), ValueError),
    "counts-long": (lambda a: _replace(a, 1, torch.cat([a[1], a[1][:1]])), ValueError),
    "capacity-axes": (lambda a: _replace(a, 2, a[2][:, :4]), ValueError),
    "vectors-1d": (lambda a: _replace(a, 0, a[0][0]), ValueError),
    "mixed-devices": (lambda a: _replace(a, 4, a[4].to("meta")), ValueError),
    "no-cuda-or-cpu": (lambda a: [t.to("meta") for t in a], ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_lp_relax_rejects_bad_arguments(case):
    make, error = BAD_ARGS[case]
    with pytest.raises(error):
        port_score.lp_relax(*make(_lp_args()), steps=3)


@pytest.mark.parametrize("steps", [-1, 2.0, True])
def test_lp_relax_rejects_bad_steps(steps):
    with pytest.raises(ValueError):
        port_score.lp_relax(*_lp_args(), steps=steps)


def test_chip_smoke_lp_family_is_the_parity_family():
    """chip_smoke.py and the card tests hold K3 to its plain version on
    chip_smoke.lp_problem, a copy (the card machine has no JAX) of the LP
    family the plain version is held to the reference on."""
    assert tuple(chip_smoke.LP_SEEDS) == tuple(LP_SEEDS)
    for seed in LP_SEEDS:
        vectors, counts, capacity, _, valid, prices = _lp_problem(seed)
        for got, want in zip(chip_smoke.lp_problem(seed), (vectors, counts, capacity, valid, prices)):
            np.testing.assert_array_equal(got, want)
    padded = chip_smoke.lp_inputs(LP_SEEDS[0], (32, 512), "cpu")
    assert [tuple(t.shape) for t in padded] == [(32, 8), (32,), (512, 8), (512,), (512,)]
    # Padding adds zero-count groups and invalid types and changes nothing.
    small = chip_smoke.lp_inputs(LP_SEEDS[0], (8, 16), "cpu")
    got = port_score.lp_relax(*padded, steps=50)
    want = port_score.lp_relax(*small, steps=50)
    np.testing.assert_allclose(got.assignment[:8, :16].numpy(), want.assignment.numpy(), rtol=0, atol=1e-6)
    assert float(got.assignment[8:].abs().sum()) == 0 and float(got.assignment[:, 16:].abs().sum()) == 0
