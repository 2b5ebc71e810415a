"""The port's resampling ops held against the JAX package: the exact
fixed-point copy counts, the counts resampler, the fused resample + gather
(``_expand_kernel`` in the JAX package, a CUDA kernel in the port), and its
lane-batched form (``_expand_lane_band_kernel`` / ``_expand_lane_block_kernel``
in the JAX package, one CUDA kernel in the port). The port's kernels take
probabilities and compute their copy counts themselves.

On the CPU the port's wrapper runs the kernel's plain version (``copy_counts``,
counts inversion, ``index_select``); the JAX expansion runs its Pallas kernel
in interpret mode, as ``tests/test_ops.py`` does. One jitted JAX expansion
per particle count keeps the interpret-mode compiles to three.

Tolerances: on the SAME copy-count boundaries, indices and values are
bit-identical (integer index arithmetic, an exact gather). From weights, the
port sums in exact fixed point and the JAX package in float32, so at large n
a boundary ``n * cumw - u`` can fall on the other side of an integer: counts
then differ by exactly 1 at a small share of boundaries. The port's own
counts are exact integers until the last conversions, so any order of the
prefix sum gives the same bits.
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

    planes, tidx = texpand._expand_plain(_t(counts), texpand._to_planes((_t(v), _t(v2)), len(v)))
    tv, tv2 = texpand._from_planes(planes, (_t(v), _t(v2)))
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
    ct = tresample.copy_counts(_t(probs), torch.tensor(u)).numpy()
    return probs, u, cj, ct


def test_resampler_from_weights_large_n_ties():
    """At large n the JAX package's float32 sum (two-stage past 2^17) and the
    port's exact fixed-point sum round differently. Fed the same
    probabilities, every copy-count boundary agrees or differs by exactly 1,
    at <= 2% of boundaries (803 of 2e5 and 17,884 of 1e6:
    ``PYTHONPATH=. python tests/test_torch_port_ops.py``); an
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


# -- the exact fixed-point copy counts -------------------------------------------


@pytest.mark.parametrize("n,seed", [(257, 0), (512, 1), (1000, 3), (4096, 1), (4096, 2)])
def test_plain_counts_match_jax_counts_small_n(n, seed):
    """The port's copy counts from probabilities == the JAX package's
    ``_counts_from_probs`` on the same probabilities at n <= 4096 (N(0, 2)
    log-weights; seeds where no float32 boundary lands on a tie)."""
    rng = np.random.default_rng(seed)
    lw = rng.normal(0.0, 2.0, n).astype(np.float32)
    u = np.float32(rng.uniform())
    probs = np.asarray(jutils.normalize(jnp.asarray(lw)))
    want = np.asarray(jexpand._counts_from_probs(jnp.asarray(probs), jnp.asarray(u)))
    np.testing.assert_array_equal(tresample.copy_counts(_t(probs), torch.tensor(u)).numpy(), want)


def _blocked_prefix(x, block):
    """Inclusive prefix sums over the last axis in another association:
    ``block``-wide block sums, an exclusive prefix over the blocks, then each
    block's running sum plus its carry (numpy, in ``x``'s own dtype)."""
    n = x.shape[-1]
    rows = -(-n // block)
    padded = np.zeros(x.shape[:-1] + (rows * block,), x.dtype)
    padded[..., :n] = x
    v = padded.reshape(x.shape[:-1] + (rows, block))
    sums = v.sum(-1, dtype=x.dtype)
    carry = np.cumsum(sums, axis=-1, dtype=x.dtype) - sums
    return (np.cumsum(v, axis=-1, dtype=x.dtype) + carry[..., None]).reshape(padded.shape)[..., :n]


@pytest.mark.parametrize("block", [1, 7, 32, 512, 4096])
def test_plain_counts_do_not_depend_on_the_order_of_the_sum(block):
    """The property the kernels rely on: the int64 prefix taken in blocks
    (as a kernel's threads, warps and tiles take it) gives the same copy
    counts, bit for bit, as ``torch.cumsum``, for one lane and for lanes. A
    float32 sum in the same blocks changes bits (checked alongside, so the
    test can tell the two apart)."""
    rng = np.random.default_rng(block)
    p32 = None
    for shape in ((20_011,), (3, 400)):
        n = shape[-1]
        probs = torch.softmax(_t(rng.normal(0.0, 2.0, shape).astype(np.float32)), dim=-1)
        u = _t(rng.uniform(size=shape[:-1]).astype(np.float32))
        q = tresample.fixed_point(probs).numpy()
        counts = tresample.counts_from_prefix(_t(_blocked_prefix(q, block)), u)
        np.testing.assert_array_equal(counts.numpy(), tresample.copy_counts(probs, u).numpy())
        assert counts.dtype == torch.int32 and int(counts[..., -1].min()) == n
        p32 = probs.numpy() if p32 is None else p32
    if block > 1:
        assert (_blocked_prefix(p32, block) != np.cumsum(p32, dtype=np.float32)).any()


def _reference_counts(probs, u):
    """Independent numpy reference of the copy counts: ``np.rint`` (half to
    even), an int64 ``np.cumsum``, float64 then float32, and float32
    arithmetic for ``n * cumw - u``."""
    n = probs.shape[-1]
    s = np.cumsum(np.rint(probs.astype(np.float64) * 2.0**60).astype(np.int64))
    cumw = (s.astype(np.float64) * 2.0**-60).astype(np.float32)
    cumw[-1] = 1.0
    counts = np.clip(np.ceil(np.float32(n) * cumw - np.float32(u)), 0, n).astype(np.int32)
    counts[-1] = n
    return counts


def _adversarial_probs(name, n):
    """Probabilities where a wrong rounding or a missing pin would show."""
    if name == "uniform":
        return np.full(n, 1.0 / n, np.float32)
    p = np.zeros(n, np.float32)
    if name.startswith("hot"):
        p[{"hot-first": 0, "hot-middle": n // 2, "hot-last": n - 1}[name]] = 1.0
        return p
    rng = np.random.default_rng(n)
    if name == "tiny":  # below 2^-60 (no mass) beside healthy particles
        p = rng.uniform(0.5, 1.5, n).astype(np.float32)
        p[::3] = 1e-20
        p[1::5] = 2.0**-61
        return (p / p.sum(dtype=np.float64)).astype(np.float32)
    p[::3] = 1.0  # zero-weight runs
    return (p / p.sum()).astype(np.float32)


@pytest.mark.parametrize("name", ["uniform", "hot-first", "hot-middle", "hot-last", "tiny", "zero-runs"])
@pytest.mark.parametrize("n", [1, 2, 257])
def test_plain_counts_monotone_on_adversarial_inputs(n, name):
    """Uniform weights with u at 0, 2^-24, 0.5, 1 - 2^-24 and 1 (every
    ``n * cumw - u`` near an integer), one hot particle, probabilities below
    2^-60 and zero-weight runs: the counts equal an independent numpy
    reference and are monotone with the last boundary n and no running
    maximum; for u <= 1/2 no source without mass gets a copy (for u near 1,
    ``n - u`` rounds to n in float32 and the last position takes the last
    source, in both packages)."""
    probs = _adversarial_probs(name, n)
    for u in (0.0, 2.0**-24, 0.5, 1.0 - 2.0**-24, 1.0):
        counts = tresample.copy_counts(_t(probs), torch.tensor(u, dtype=torch.float32)).numpy()
        np.testing.assert_array_equal(counts, _reference_counts(probs, u))
        assert counts[-1] == n and counts.min() >= 0 and (np.diff(counts) >= 0).all()
        idx = tresample.invert_counts(_t(counts)).numpy()
        assert ((idx >= 0) & (idx < n)).all()
        massless = tresample.fixed_point(_t(probs)).numpy() == 0
        if u <= 0.5:
            assert not massless[idx].any()


@pytest.mark.parametrize("n,batch", [(257, ()), (3200, ()), (400, (16,)), (3200, (5,)), (40, (2, 3))])
def test_plain_from_probs_is_counts_then_expansion(n, batch):
    """Each kernel's plain version from probabilities (what a CPU tensor gets
    from the wrapper) == plain counts, then the plain expansion from counts,
    == the counts resampler + gather, bit for bit."""
    rng = np.random.default_rng(n + len(batch))
    probs = torch.softmax(_t(rng.normal(0.0, 2.0, (n, *batch)).astype(np.float32)), dim=0)
    u = _t(rng.uniform(size=batch).astype(np.float32))
    want = tresample.systematic_counts(None, probs, normalized=True, u=u)
    if not batch:
        v2d = _t(rng.normal(size=(2, n)).astype(np.float32))
        out, idx = texpand.fused_expand(probs, u, v2d)
        ref_out, ref_idx = texpand._expand_plain(tresample.copy_counts(probs, u), v2d)
    else:
        lanes = probs.reshape(n, -1)
        planes = _t(rng.normal(size=(2, n, lanes.shape[1])).astype(np.float32))
        out, idx = texpand.fused_expand_lanes(lanes, u.reshape(-1), planes)
        ref_out, ref_idx = texpand._expand_lanes_plain(tresample.copy_counts(lanes.T, u.reshape(-1)), planes)
    assert idx.dtype == torch.int32
    assert torch.equal(idx, ref_idx) and torch.equal(out, ref_out)
    np.testing.assert_array_equal(idx.numpy().reshape(want.shape), want.numpy())


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
    # the lane kernel's plain version writes idx in the kernel's (n, L) layout
    _, pidx = texpand._expand_lanes_probs_plain(torch.softmax(_t(lw).reshape(n, -1), 0), _t(u).reshape(-1),
                                                _t(vals[..., 0]).reshape(1, n, -1))
    assert pidx.is_contiguous() and pidx.shape == (n, np.prod(batch))


def test_fused_expand_refuses_other_devices():
    """The wrapper takes the plain version only for CPU tensors: anything
    else launches the kernel or raises — no quiet fallback, and no mix of
    devices."""
    probs = torch.empty(8, dtype=torch.float32, device="meta")
    v2d = torch.empty(1, 8, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        texpand.fused_expand(probs, torch.empty((), device="meta"), v2d)
    with pytest.raises(ValueError, match="CUDA"):
        texpand.fused_expand_lanes(probs.reshape(4, 2), torch.empty(2, device="meta"), v2d.reshape(1, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        texpand.fused_expand(torch.full((8,), 0.125), torch.tensor(0.5), v2d)


if __name__ == "__main__":
    # the cumsum-order ties: copy-count boundaries that differ between the two
    # packages, from the same probabilities (N(0, 2) log-weights, seed 0, u = 0.37)
    for n in (512, 4096, 100_000, 200_000, 1_000_000):
        _, _, cj, ct = _boundaries_both(n)
        dc = np.abs(cj.astype(np.int64) - ct)
        print(f"n={n}: {int((dc > 0).sum())} of {n} boundaries differ, largest difference {int(dc.max())}")
    # the port's boundaries without a running maximum: none falls below its
    # predecessor (the fixed-point sum is exact, every later step monotone)
    for n in (1_000_000, 1_000_003):
        probs, u, _, ct = _boundaries_both(n)
        print(f"n={n}: {int((ct[1:] < ct[:-1]).sum())} boundaries below their predecessor")
