"""The port's resampling ops held against the JAX package: the two-stage
cumulative sum, the counts resampler, the fused resample + gather
(``_expand_kernel`` in the JAX package, a CUDA kernel in the port), and its
lane-batched form (``_expand_lane_band_kernel`` / ``_expand_lane_block_kernel``
in the JAX package, one CUDA kernel in the port).

On the CPU the port's wrapper runs the kernel's plain version (counts
inversion + ``index_select``); the JAX expansion runs its Pallas kernel in
interpret mode, as ``tests/test_ops.py`` does. One jitted JAX expansion per
particle count keeps the interpret-mode compiles to three.

Tolerances: on the SAME copy-count boundaries, indices and values are
bit-identical (integer index arithmetic, an exact gather). From weights,
``torch.cumsum`` and ``jnp.cumsum`` add in different orders, so at large n a
boundary ``n * cumw - u`` can fall on the other side of an integer: counts
then differ by exactly 1 at a small share of boundaries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfilter_tpu import utils as jutils
from pyfilter_tpu.ops import expand as jexpand
from pyfilter_tpu.ops import resample as jresample
from pyfilter_tpu.ops import systematic_counts as j_counts
from pyfilter_tpu_torch.ops import expand as texpand
from pyfilter_tpu_torch.ops import resample as tresample

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# one compile per particle count: values ride as a tuple (scalar-event
# values, (2,)-event values), so one call covers both event shapes and the
# tuple structure
_jax_expand = jax.jit(lambda lw, vals, u: jexpand.systematic_expand(None, lw, vals, u=u))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _case(n, seed=0, lw=None):
    rng = np.random.default_rng(seed)
    if lw is None:
        lw = rng.normal(0.0, 2.0, n).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    v2 = rng.normal(size=(n, 2)).astype(np.float32)
    return lw, v, v2


def _check_same_counts(lw, v, v2, u):
    """Port's plain expansion on the JAX package's copy-count boundaries ==
    JAX ``systematic_expand`` == JAX counts inversion + take, bit for bit."""
    probs = jutils.normalize(jnp.asarray(lw))
    counts = np.asarray(jexpand._counts_from_probs(probs, jnp.float32(u)))
    (jv, jv2), jidx = _jax_expand(jnp.asarray(lw), (jnp.asarray(v), jnp.asarray(v2)), jnp.float32(u))
    inv = np.asarray(jexpand._invert_counts(jnp.asarray(counts)))
    np.testing.assert_array_equal(np.asarray(jidx), inv)

    v2d = _t(np.concatenate([v[None], v2.T], axis=0))
    planes, idx = texpand._expand_plain(_t(counts), v2d)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), inv)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jnp.take(jnp.asarray(v2d.numpy()), inv, axis=1)))

    (tv, tv2), tidx = texpand.expand_from_counts(_t(counts), (_t(v), _t(v2)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    return inv


@pytest.mark.parametrize("n", [257, 1000, 4096])
def test_expand_plain_matches_jax_on_same_counts(n):
    lw, v, v2 = _case(n, seed=n)
    _check_same_counts(lw, v, v2, np.random.default_rng(n + 1).uniform())


@pytest.mark.parametrize("hot", [0, 17, 4095])
def test_expand_plain_degenerate_weights(hot):
    """All mass on one particle: every output takes ``hot``."""
    n = 4096
    lw = np.full(n, -np.inf, np.float32)
    lw[hot] = 0.0
    _, v, v2 = _case(n, seed=1)
    idx = _check_same_counts(lw, v, v2, 0.5)
    assert (idx == hot).all()


def test_expand_plain_zero_count_runs():
    """Alternating zero-weight runs: two of every three sources get no copy."""
    n = 4096
    lw = np.where(np.arange(n) % 3 == 0, 0.0, -np.inf).astype(np.float32)
    _, v, v2 = _case(n, seed=2)
    idx = _check_same_counts(lw, v, v2, 0.7)
    assert (idx % 3 == 0).all()


def test_expand_u_one_edge():
    """``u == 1.0`` leaves the last boundary at n - 1 before the pin; the
    pinned expansion and the self-clamping inversion still agree."""
    n = 1000
    lw, v, v2 = _case(n, seed=3)
    idx = _check_same_counts(lw, v, v2, 1.0)
    ref = tresample.systematic_counts(None, _t(lw), u=1.0)
    np.testing.assert_array_equal(ref.numpy(), idx)
    assert int(ref.max()) < n


@pytest.mark.parametrize("n,event", [(257, ()), (1000, (2,)), (4096, (3, 2))])
def test_port_systematic_expand_matches_its_counts_resampler(n, event):
    """Inside the port: the fused expansion == counts inversion + gather."""
    rng = np.random.default_rng(4)
    lw = _t(rng.normal(0.0, 2.0, n).astype(np.float32))
    vals = _t(rng.normal(size=(n, *event)).astype(np.float32))
    ref_idx = tresample.systematic_counts(None, lw, u=0.25)
    out, idx = texpand.systematic_expand(None, lw, vals, u=0.25)
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    np.testing.assert_array_equal(out.numpy(), vals.numpy()[ref_idx.numpy()])
    out2, idx2 = texpand.systematic_expand(torch.Generator().manual_seed(0), lw, vals)
    assert out2.shape == vals.shape and idx2.dtype == torch.int32


@pytest.mark.parametrize("n", [512, 4096])
def test_resampler_from_weights_matches_jax_small_n(n):
    """From log-weights (each package normalizes and sums on its own) at
    n <= 4096, seed 0: no boundary lands on a tie, so indices are equal."""
    lw = np.random.default_rng(0).normal(0.0, 2.0, n).astype(np.float32)
    u = np.float32(0.37)
    want = np.asarray(j_counts(None, jnp.asarray(lw), u=jnp.asarray(u)))
    got = tresample.systematic_counts(None, _t(lw), u=float(u))
    np.testing.assert_array_equal(got.numpy(), want)
    out, idx = texpand.systematic_expand(None, _t(lw), _t(np.arange(n, dtype=np.float32)), u=float(u))
    np.testing.assert_array_equal(idx.numpy(), want)


def test_resampler_lanes_from_weights_matches_jax():
    """Lanes ``(N, 3)``, one uniform each, at N = 512 (seed 1: no ties)."""
    n = 512
    lanes = np.random.default_rng(1).normal(0.0, 2.0, (n, 3)).astype(np.float32)
    us = np.asarray([0.1, 0.5, 0.9], np.float32)
    want = np.asarray(j_counts(None, jnp.asarray(lanes), u=jnp.asarray(us)))
    np.testing.assert_array_equal(tresample.systematic_counts(None, _t(lanes), u=_t(us)).numpy(), want)


def _boundaries_both(n, seed=0, u=0.37):
    """N(0, 2) log-weights from ``seed``, normalized by the JAX package; both
    packages' copy-count boundaries from those same probabilities."""
    lw = np.random.default_rng(seed).normal(0.0, 2.0, n).astype(np.float32)
    probs = np.asarray(jutils.normalize(jnp.asarray(lw)))
    u = np.float32(u)
    cj = np.asarray(jexpand._counts_from_probs(jnp.asarray(probs), jnp.asarray(u)))
    ct = texpand._counts_from_probs(_t(probs), torch.tensor(u)).numpy()
    return probs, u, cj, ct


def test_resampler_from_weights_large_n_ties():
    """Past 2^17 both packages take the two-stage cumsum, but add in
    different orders. Fed the same probabilities, every copy-count boundary
    agrees or differs by exactly 1, at <= 2% of boundaries (the counts at
    2e5 and 1e6: ``PYTHONPATH=. python tests/test_torch_port_ops.py``); an
    ancestor index moves only where a boundary moved, and only across
    sources that share that boundary (zero-copy runs), so indices differ at
    <= 2% of positions."""
    n = 200_000
    probs, u, cj, ct = _boundaries_both(n)
    np.testing.assert_allclose(
        tresample.prob_cumsum(_t(probs)).numpy(), np.asarray(jresample.prob_cumsum(jnp.asarray(probs))),
        atol=1e-6, rtol=0,
    )
    dc = np.abs(cj.astype(np.int64) - ct)
    assert dc.max() <= 1 and (dc > 0).mean() <= 0.02

    ij = np.asarray(j_counts(None, jnp.asarray(probs), normalized=True, u=jnp.asarray(u)))
    it = tresample.systematic_counts(None, _t(probs), normalized=True, u=float(u)).numpy()
    diff = np.flatnonzero(ij != it)
    assert diff.size <= 0.02 * n
    for i in diff:
        lo, hi = sorted((ij[i], it[i]))
        # every source in [lo, hi) has its boundary right at i or i + 1
        assert np.all(np.abs(cj[lo:hi].astype(np.int64) - i - 0.5) == 0.5)


# -- lane batches ----------------------------------------------------------------
_LANE_CASES = [(400, (16,)), (400, (200,)), (257, (5,)), (72, (16,)), (40, (16,)), (3000, (3,))]


def _jax_lane_counts(lw, u):
    """Per-lane copy-count boundaries ``(n, L)`` with the JAX package's own
    arithmetic (``pyfilter_tpu/ops/expand.py:749-753``)."""
    n = lw.shape[0]
    probs = jutils.normalize(jnp.asarray(lw), axis=0).reshape(n, -1)
    cumw = jnp.cumsum(probs, axis=0).at[-1, :].set(1.0)
    counts = jnp.clip(jnp.ceil(n * cumw - jnp.asarray(u).reshape(-1)[None, :]), 0, n).astype(jnp.int32)
    return np.asarray(counts.at[-1, :].set(n))


def _lane_case(n, batch, scale, seed):
    """N(0, scale) log-weights with lane 0 degenerate (all mass on one
    particle: the first, middle or last, by ``seed``) and, where there is a
    second lane, lane 1 drawn with ``u = 1.0``; two value arrays, as the APF
    passes ``(x, pre_weights)``."""
    rng = np.random.default_rng(seed)
    lw = (rng.normal(size=(n, *batch)) * scale).astype(np.float32)
    flat = lw.reshape(n, -1)
    flat[:, 0] = -np.inf
    flat[(0, n // 2, n - 1)[seed % 3], 0] = 0.0
    u = rng.uniform(size=batch).astype(np.float32)
    u.reshape(-1)[1:2] = 1.0
    vals = (rng.normal(size=(n, *batch)).astype(np.float32), rng.normal(size=(n, *batch)).astype(np.float32))
    return lw, u, vals


def _planes(vals):
    n = vals[0].shape[0]
    return _t(np.stack([v.reshape(n, -1) for v in vals]))


@pytest.mark.parametrize("scale", [1.0, 6.0])
@pytest.mark.parametrize("n,batch", _LANE_CASES)
def test_expand_lanes_plain_matches_jax_on_same_counts(n, batch, scale):
    """On the JAX package's copy-count boundaries, the port's lane plain
    version == per-lane JAX counts inversion + take, bit for bit, and agrees
    with the port's own from-weights path where the counts agree."""
    lw, u, vals = _lane_case(n, batch, scale, seed=n + len(batch) + int(scale))
    counts = _jax_lane_counts(lw, u)  # (n, L)
    inv = np.asarray(jax.vmap(jexpand._invert_counts)(jnp.asarray(counts.T))).T  # (n, L)
    planes = _planes(vals)
    out, idx = texpand._expand_lanes_plain(_t(counts.T.copy()), planes)
    assert idx.dtype == torch.int32 and idx.shape == (n, planes.shape[2])
    np.testing.assert_array_equal(idx.numpy(), inv)
    np.testing.assert_array_equal(out.numpy(), np.take_along_axis(planes.numpy(), inv[None], axis=1))
    assert (inv[:, 0] == (0, n // 2, n - 1)[(n + len(batch) + int(scale)) % 3]).all()


@pytest.mark.parametrize("n,batch,scale", [(400, (16,), 6.0), (257, (5,), 1.0), (72, (16,), 1.0), (40, (16,), 1.0)])
def test_expand_lanes_plain_matches_jax_kernel(n, batch, scale):
    """Against JAX ``systematic_expand_lanes`` itself (its banded and
    full-scan Pallas kernels, in interpret mode): indices and both value
    arrays, bit for bit, on the same counts. Four cases of the set above
    (interpret mode costs seconds per shape); the band tiers, the full-scan
    fallback and n below every band window are among them."""
    lw, u, vals = _lane_case(n, batch, scale, seed=n)
    (jv, jp), jidx = jax.jit(lambda w, a, b, uu: jexpand.systematic_expand_lanes(None, w, (a, b), u=uu))(
        jnp.asarray(lw), jnp.asarray(vals[0]), jnp.asarray(vals[1]), jnp.asarray(u)
    )
    counts = _jax_lane_counts(lw, u)
    out, idx = texpand._expand_lanes_plain(_t(counts.T.copy()), _planes(vals))
    np.testing.assert_array_equal(idx.numpy().reshape(jidx.shape), np.asarray(jidx))
    np.testing.assert_array_equal(out[0].numpy().reshape(jv.shape), np.asarray(jv))
    np.testing.assert_array_equal(out[1].numpy().reshape(jp.shape), np.asarray(jp))


@pytest.mark.parametrize("n,batch,seed", [(400, (16,), 1), (257, (5,), 2), (512, (4, 3), 5)])
def test_lane_resampler_from_weights_matches_jax(n, batch, seed):
    """From log-weights (each package normalizes and sums on its own) at
    n <= 512, seeds without ties: the port's fused lane resample gives the
    JAX package's ``systematic_counts`` indices, and gathers each value
    array by them."""
    rng = np.random.default_rng(seed)
    lw = rng.normal(0.0, 2.0, (n, *batch)).astype(np.float32)
    u = rng.uniform(size=batch).astype(np.float32)
    vals = rng.normal(size=(n, *batch, 2)).astype(np.float32)
    want = np.asarray(j_counts(None, jnp.asarray(lw), u=jnp.asarray(u)))
    (tv, tw), idx = texpand.systematic_expand_lanes(None, _t(lw), (_t(vals), _t(lw)), u=_t(u))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(tv.numpy(), np.take_along_axis(vals, want[..., None], axis=0))
    np.testing.assert_array_equal(tw.numpy(), np.take_along_axis(lw, want, axis=0))
    _, idx2 = texpand.systematic_expand_lanes(torch.Generator().manual_seed(0), _t(lw), _t(vals))
    assert idx2.shape == (n, *batch) and idx2.dtype == torch.int32
    # the kernel takes contiguous counts only
    assert texpand._lane_counts_from_probs(torch.softmax(_t(lw).reshape(n, -1), 0), _t(u).reshape(-1)).is_contiguous()


def test_fused_expand_refuses_other_devices():
    """The wrapper takes the plain version only for CPU tensors: anything
    else launches the kernel or raises — no quiet fallback."""
    counts = torch.empty(8, dtype=torch.int32, device="meta")
    v2d = torch.empty(1, 8, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        texpand.fused_expand(counts, v2d)
    with pytest.raises(ValueError, match="CUDA"):
        texpand.fused_expand_lanes(counts.reshape(2, 4), v2d.reshape(1, 4, 2))


if __name__ == "__main__":
    # the cumsum-order ties: copy-count boundaries that differ between the two
    # packages, from the same probabilities (N(0, 2) log-weights, seed 0, u = 0.37)
    for n in (512, 4096, 100_000, 200_000, 1_000_000):
        _, _, cj, ct = _boundaries_both(n)
        dc = np.abs(cj.astype(np.int64) - ct)
        print(f"n={n}: {int((dc > 0).sum())} of {n} boundaries differ, largest difference {int(dc.max())}")
    # the port's boundaries before their running maximum: how many fall below
    # their predecessor (the two-stage cumsum's row seams)
    for n in (1_000_000, 1_000_003):
        probs, u, _, _ = _boundaries_both(n)
        cumw = tresample.prob_cumsum(_t(probs))
        cumw[-1] = 1.0
        raw = torch.clamp(torch.ceil(n * cumw - float(u)), 0, n).to(torch.int64)
        print(f"n={n}: {int((raw[1:] < raw[:-1]).sum())} boundaries below their predecessor before the running max")
