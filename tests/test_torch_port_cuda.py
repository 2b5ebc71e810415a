"""The port's CUDA kernels on the card (marker ``cuda``; skips without a GPU).

This file imports only torch, the port and ``chip_smoke`` (its index
generators), so it also runs where JAX is not installed (skip the JAX-side
conftest there):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

import chip_smoke
import pyfilter_tpu_torch as pt
from pyfilter_tpu_torch.ops import expand

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# uniforms where a wrong rounding shows: every n * cumw - u of uniform weights
# lies near an integer
_EDGE_US = (0.0, 2.0**-24, 0.5, 1.0 - 2.0**-24, 1.0)


def _edge_probs(n, name, dev):
    """Uniform probabilities, or masses below 2^-60 (no fixed-point mass)
    beside healthy ones."""
    if name == "uniform":
        return torch.full((n,), 1.0 / n, device=dev)
    p = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n), device=dev) + 0.5
    p[::3] = 1e-20
    p[1::5] = 2.0**-61
    return p / p.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 257, 8192, 8193, 1_000_003])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_expand_kernel_matches_plain_on_card(cuda, n, d):
    """Bit for bit against the plain version (counts prep included), on
    random, degenerate and zero-run weights with a random u and u == 1.0, and
    on uniform and sub-2^-60 probabilities at the edge uniforms."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    v2d = torch.randn(d, n, generator=g, device=cuda)
    hot = torch.full((n,), -math.inf, device=cuda)
    hot[n // 2] = 0.0
    zero_runs = torch.where(torch.arange(n, device=cuda) % 3 == 0, 0.0, -math.inf)
    cases = [(torch.softmax(lw, 0), u) for lw in (torch.randn(n, generator=g, device=cuda) * 2.0, hot, zero_runs)
             for u in (0.37, 1.0)]
    cases += [(_edge_probs(n, name, cuda), u) for name in ("uniform", "tiny") for u in _EDGE_US]
    for probs, u in cases:
        ut = torch.tensor(u, device=cuda)
        before = expand.fused_expand.launches
        out, idx = expand.fused_expand(probs, ut, v2d)
        ref_out, ref_idx = expand._expand_probs_plain(probs, ut, v2d)
        torch.cuda.synchronize()
        assert expand.fused_expand.launches == before + 1
        assert torch.equal(idx, ref_idx) and torch.equal(out, ref_out)


@pytest.mark.cuda
def test_expand_kernel_lookback_state_across_calls(cuda):
    """The look-back state resets itself: calls at changing n, on the default
    and on a side stream, each match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    side = torch.cuda.Stream()
    for n, stream in ((1_000_000, None), (5000, None), (1_000_000, side), (8193, None), (1_000_000, None)):
        probs = torch.softmax(torch.randn(n, generator=g, device=cuda), 0)
        u = torch.rand((), generator=g, device=cuda)
        v2d = torch.randn(1, n, generator=g, device=cuda)
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            if stream is not None:
                stream.wait_stream(torch.cuda.default_stream())
            out, idx = expand.fused_expand(probs, u, v2d)
        torch.cuda.synchronize()
        ref_out, ref_idx = expand._expand_probs_plain(probs, u, v2d)
        assert torch.equal(idx, ref_idx) and torch.equal(out, ref_out)


@pytest.mark.cuda
def test_sisr_on_card_goes_through_the_kernel(cuda):
    model = pt.examples.stochastic_volatility_model(0.5, 1.0, 0.3, dt=0.2)
    filt = pt.SISR(model, 1 << 16)
    y = torch.randn(20, generator=torch.Generator().manual_seed(0))
    before = expand.fused_expand.launches
    res = filt.batch_filter(torch.Generator(device=cuda).manual_seed(0), y)
    assert math.isfinite(float(res.log_likelihood))
    assert expand.fused_expand.launches - before == filt.n_resamples > 0


def _lane_weights(n, n_lanes, scale, g, dev):
    """N(0, scale) log-weights ``(n, L)``; lane 0 has all mass on one particle
    (first, middle, last by ``n``), lane 1 alternating zero-weight runs, lane
    2 uniform weights."""
    lw = torch.randn(n, n_lanes, generator=g, device=dev) * scale
    lw[:, 0] = -math.inf
    lw[(0, n // 2, n - 1)[n % 3], 0] = 0.0
    if n_lanes > 1:
        lw[:, 1] = torch.where(torch.arange(n, device=dev) % 3 == 0, 0.0, -math.inf)
    if n_lanes > 2:
        lw[:, 2] = 0.0
    return lw


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_lanes", [(400, 100), (400, 1000), (257, 5), (40, 16), (72, 16), (800, 64), (3200, 33),
                                       (1, 4), (2, 9), (7104, 9), (7105, 9)])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_expand_lanes_kernel_matches_plain_on_card(cuda, n, n_lanes, d):
    """Bit for bit against the plain version (counts prep included): weight
    scales 1 and 6, a degenerate lane, zero-weight runs, uniform weights,
    random uniforms and the edge uniforms; n = 7104 keeps the counts in
    shared memory, n = 7105 takes the global scratch route; d = 3 runs the
    remainder pass after a pair of planes (the Lorenz model's 3-D state)."""
    g = torch.Generator(device=cuda).manual_seed(n + n_lanes + d)
    planes = torch.randn(d, n, n_lanes, generator=g, device=cuda)
    for scale in (1.0, 6.0):
        probs = torch.softmax(_lane_weights(n, n_lanes, scale, g, cuda), dim=0)
        us = [torch.rand(n_lanes, generator=g, device=cuda)] + [torch.full((n_lanes,), u, device=cuda) for u in _EDGE_US]
        for u in us:
            before = expand.fused_expand_lanes.launches
            out, idx = expand.fused_expand_lanes(probs, u, planes)
            ref_out, ref_idx = expand._expand_lanes_probs_plain(probs, u, planes)
            torch.cuda.synchronize()
            assert expand.fused_expand_lanes.launches == before + 1
            assert torch.equal(idx, ref_idx) and torch.equal(out, ref_out)


@pytest.mark.cuda
def test_apf_lanes_on_card_go_through_the_kernel(cuda):
    model = pt.examples.stochastic_volatility_model(0.5, 1.0, 0.3, dt=0.2)
    filt = pt.APF(model, 256, batch_shape=(64,))
    y = torch.randn(20, generator=torch.Generator().manual_seed(0))
    before, steps = expand.fused_expand_lanes.launches, pt.APF.corrections
    res = filt.batch_filter(torch.Generator(device=cuda).manual_seed(0), y)
    assert torch.isfinite(res.log_likelihood).all() and res.log_likelihood.shape == (64,)
    assert expand.fused_expand_lanes.launches - before == pt.APF.corrections - steps == 20


def _ar_model(device=None):
    hidden = pt.timeseries.models.AR(0.2, 0.7, 0.4, device=device)
    return pt.timeseries.LinearStateSpaceModel(hidden, (1.0, 0.25))


def _ar_data_and_oracle(n_obs=60):
    """AR observations from the float64 oracle of ``tests/kalman.py`` and its
    RTS smoothing moments."""
    import numpy as np

    from kalman import KalmanFilter

    oracle = KalmanFilter([[0.7]], [[1.0]], [[0.16]], [[0.0625]], transition_offsets=[0.2],
                          initial_state_mean=[0.2], initial_state_covariance=[[0.16]])
    _, y = oracle.sample(n_obs, rng=np.random.default_rng(11))
    sm, sp = oracle.smooth(y)
    return y[:, 0].astype(np.float32), sm[:, 0], sp[:, 0, 0]


@pytest.mark.cuda
def test_record_states_on_card(cuda):
    """Full and bounded histories on the card: leaves on the device, time
    indexes on the host, the bounded one the tail of the full one; every
    resample fire one launch of the expand kernel."""
    y, _, _ = _ar_data_and_oracle(30)
    filt = pt.SISR(_ar_model(), 4096, record_states=True)
    before = expand.fused_expand.launches
    res = filt.batch_filter(torch.Generator(device=cuda).manual_seed(0), y)
    h = res.states
    assert h.values.shape == h.log_weights.shape == h.prev_indices.shape == (31, 4096)
    assert h.values.device.type == "cuda" and h.time_indexes.device.type == "cpu"
    assert h.time_indexes.tolist() == list(range(31))
    assert expand.fused_expand.launches - before == filt.n_resamples > 0
    tail = pt.SISR(_ar_model(), 4096, record_states=5).batch_filter(torch.Generator(device=cuda).manual_seed(0), y)
    for a, b in zip(tail.states, h):
        assert torch.equal(a, b[-5:])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ffbs", "ffbsi"])
def test_smoothers_on_card_against_oracle(cuda, method):
    """Exact FFBS and rejection FFBSi on the card hit the RTS smoothing
    marginals within the JAX package's Monte Carlo bound."""
    import numpy as np

    y, sm_mean, sm_var = _ar_data_and_oracle()
    filt = pt.SISR(_ar_model(), 2000, record_states=True)
    res = filt.batch_filter(torch.Generator(device=cuda).manual_seed(1), y)
    traj = filt.smooth(torch.Generator(device=cuda).manual_seed(2), res, method=method)
    assert traj.shape == (61, 2000) and traj.device.type == "cuda"
    means = traj.double().mean(dim=1).cpu().numpy()[1:]
    np.testing.assert_allclose(means, sm_mean, atol=4.5 * np.sqrt(sm_var / 2000).max() + 0.02)


@pytest.mark.cuda
def test_sisr_lanes_kernel_matches_plain_run(cuda, monkeypatch):
    """SISR over lanes through the lane kernel, and the same run (same
    generator seed) through its plain version: identical histories and
    log-likelihoods, one lane-kernel launch per step."""
    y, _, _ = _ar_data_and_oracle(30)

    def run():
        filt = pt.SISR(_ar_model(), 400, batch_shape=(8,), record_states=True)
        return filt.batch_filter(torch.Generator(device=cuda).manual_seed(3), y)

    before = expand.fused_expand_lanes.launches
    kernel = run()
    assert expand.fused_expand_lanes.launches - before == 30
    monkeypatch.setattr(expand, "fused_expand_lanes", expand._expand_lanes_probs_plain)
    plain = run()
    assert torch.equal(kernel.log_likelihood, plain.log_likelihood)
    for a, b in zip(kernel.states[1:], plain.states[1:]):
        assert torch.equal(a, b)


def test_entry_points_refuse_without_a_card(monkeypatch):
    """Without a card, the smoothing path's entry points raise unless given
    ``device="cpu"``: models, filters that record, SISR over lanes, converted
    histories."""
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_model = _ar_model("cpu")
    for make in (
        lambda: pt.timeseries.models.AR(0.2, 0.7, 0.4),
        lambda: pt.timeseries.models.RandomWalk(0.3),
        lambda: pt.examples.sine_diffusion_model(),
        lambda: pt.SISR(cpu_model, 100, record_states=True),
        lambda: pt.SISR(cpu_model, 100, batch_shape=(3,)),
        lambda: pt.convert.history_from_numpy(np.zeros(2), np.zeros((2, 4)), np.zeros((2, 4)), np.zeros((2, 4), int)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    filt = pt.SISR(cpu_model, 100, record_states=True, device="cpu")
    res = filt.batch_filter(torch.Generator().manual_seed(0), np.zeros(5, np.float32))
    assert filt.smooth(torch.Generator().manual_seed(1), res, method="ffbsi").device.type == "cpu"


@pytest.mark.cuda
def test_quasi_draws_copy_once_per_draw_on_card(cuda):
    """A quasi context on the card: its Sobol start and each quasi-random
    candidate draw are one host-to-device copy each, landing on the card."""
    from pyfilter_tpu_torch import inference as inf

    k = 100
    ctx = inf.make_context(use_quasi=True, generator=torch.Generator(device=cuda).manual_seed(0))
    ctx.set_batch_shape((k,))
    pt.examples.stochastic_volatility_builder(ctx)
    ctx.initialize_parameters()
    engine = ctx.quasi_engine
    assert engine.n_copies == 1 and engine.n_drawn == k
    assert all(v.device.type == "cuda" for v in ctx.parameters.values())
    state = inf.SequentialAlgorithmState(torch.zeros(k, device=cuda), None)
    kernel = inf.SymmetricMH().build(ctx, state, None, None)
    assert isinstance(kernel, inf.QuasiMultivariateNormal)
    for draw in range(1, 4):
        rvs = kernel.sample(None, (k,))
        assert rvs.device.type == "cuda" and rvs.shape == (k, 6) and bool(torch.isfinite(rvs).all())
        assert engine.n_copies == 1 + draw and engine.n_drawn == k * (1 + draw)


@pytest.mark.cuda
def test_sisr_past_the_fused_limit_on_card_skips_the_kernel(cuda):
    """A single-lane SISR at N = 2^24 on the card resamples through its
    resampler and a gather: the expand kernel does not launch."""
    import numpy as np

    filt = pt.SISR(_ar_model(), 1 << 24, ess_threshold=1.0 + 1e-6, record_moments=False)
    before = expand.fused_expand.launches
    res = filt.batch_filter(torch.Generator(device=cuda).manual_seed(0), np.asarray([0.1, -0.2], np.float32))
    assert filt.n_resamples == 2 and expand.fused_expand.launches == before
    assert math.isfinite(float(res.log_likelihood))


def test_quasi_and_pmmh_entry_points_refuse_without_a_card(monkeypatch):
    """Without a card, the quasi context, its engine and PMMH raise unless
    given ``device="cpu"``."""
    from pyfilter_tpu_torch import inference as inf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_filter = pt.SISR(_ar_model("cpu"), 10, device="cpu")
    for make in (
        lambda: inf.make_context(use_quasi=True),
        lambda: inf.EngineContainer(3, True),
        lambda: inf.PMMH(cpu_filter, 2, context=inf.make_context(device="cpu")),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    alg = inf.PMMH(cpu_filter, 2, context=inf.make_context(use_quasi=True, device="cpu"), device="cpu")
    assert alg.device.type == "cpu"


def _rw2d_model(device):
    import numpy as np

    return pt.convert.rw2d_from_numpy(np.eye(2, dtype=np.float32), np.array([0.05, 0.1], np.float32),
                                      np.full(2, 0.15, np.float32), device=device)


@pytest.mark.cuda
def test_oracle_filters_on_card_launch_as_they_resample(cuda):
    """The damped-Newton SISR on the 2-D walk resamples through the expand
    kernel at d = 2, once per fire; the GPF (damped-Newton
    GaussianLinearized) launches no kernel; both finite, on the card."""
    props = pt.filters.particle.proposals
    model = _rw2d_model("cuda")
    y = torch.cumsum(torch.randn(20, 2, generator=torch.Generator().manual_seed(0)), 0) * 0.1
    before = (expand.fused_expand.launches, expand.fused_expand_lanes.launches)
    sisr = pt.SISR(model, 1500, proposal=props.Linearized(n_steps=5, use_second_order=True))
    res = sisr.batch_filter(torch.Generator(device=cuda).manual_seed(0), y)
    assert math.isfinite(float(res.log_likelihood))
    assert expand.fused_expand.launches - before[0] == sisr.n_resamples > 0
    before = (expand.fused_expand.launches, expand.fused_expand_lanes.launches)
    gpf = pt.GPF(model, 1500, proposal=props.GaussianLinearized(n_steps=5, use_second_order=True))
    res = gpf.batch_filter(torch.Generator(device=cuda).manual_seed(1), y)
    assert math.isfinite(float(res.log_likelihood))
    assert (expand.fused_expand.launches, expand.fused_expand_lanes.launches) == before


def test_oracle_entry_points_refuse_without_a_card(monkeypatch):
    """Without a card, the suite's models and the GPF raise unless given
    ``device="cpu"``."""
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f32 = np.float32
    for make in (
        lambda: _rw2d_model(None),
        lambda: pt.convert.joint_random_walks_from_numpy(np.array([0.05, 0.1], f32), np.eye(2, dtype=f32),
                                                         np.full(2, 0.15, f32)),
        lambda: pt.convert.ukf_benchmark_from_numpy(f32(3.0), f32(1.0)),
        lambda: pt.GPF(_rw2d_model("cpu"), 10),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert pt.GPF(_rw2d_model("cpu"), 10, device="cpu").device.type == "cpu"


def _float64_scatter(g, idx):
    """The float64 transpose of the gather and each source's sum of |g| (its
    run's mass), ``g`` ``(d, n[, L])``, ``idx`` ``(n[, L])``."""
    return chip_smoke.float64_scatter(torch, g, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 257, 8193, 1_000_003])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", ["random", "degenerate"])
def test_expand_backward_kernel_on_card(cuda, n, d, name):
    """``loss.backward()`` through ``fused_expand`` reaches the values through
    the backward kernel (one launch), the same bits at a second launch, each
    source within 1e-6 of its run's sum of |g| of a float64 scatter-add, and
    the plain backward's value within the same bound."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    lw = torch.randn(n, generator=g, device=cuda) * 2.0
    if name == "degenerate":
        lw = torch.full((n,), -math.inf, device=cuda)
        lw[n // 2] = 0.0
    v2d = torch.randn(d, n, generator=g, device=cuda).requires_grad_(True)
    out, idx = expand.fused_expand(torch.softmax(lw, 0), torch.tensor(0.37, device=cuda), v2d)
    cot = torch.randn(d, n, generator=g, device=cuda)
    before = expand.fused_expand_backward.launches
    (out * cot).sum().backward()
    assert expand.fused_expand_backward.launches == before + 1
    ref, mass = _float64_scatter(cot, idx)
    assert bool(((v2d.grad.double() - ref).abs() <= 1e-6 * mass).all())
    assert torch.equal(v2d.grad, expand.fused_expand_backward(cot, idx))
    plain = expand._expand_backward_plain(cot, idx)
    assert bool(((plain.double() - ref).abs() <= 1e-6 * mass + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_lanes", [(400, 1000), (257, 5), (7105, 40), (2, 9)])
@pytest.mark.parametrize("d", [1, 3])
def test_expand_lanes_backward_kernel_on_card(cuda, n, n_lanes, d):
    """The same through ``fused_expand_lanes``, lane 0 degenerate."""
    g = torch.Generator(device=cuda).manual_seed(n + n_lanes + d)
    lw = torch.randn(n, n_lanes, generator=g, device=cuda) * 2.0
    lw[:, 0] = -math.inf
    lw[n - 1, 0] = 0.0
    planes = torch.randn(d, n, n_lanes, generator=g, device=cuda).requires_grad_(True)
    out, idx = expand.fused_expand_lanes(torch.softmax(lw, 0), torch.rand(n_lanes, generator=g, device=cuda), planes)
    cot = torch.randn(d, n, n_lanes, generator=g, device=cuda)
    before = expand.fused_expand_lanes_backward.launches
    (out * cot).sum().backward()
    assert expand.fused_expand_lanes_backward.launches == before + 1
    ref, mass = _float64_scatter(cot, idx)
    assert bool(((planes.grad.double() - ref).abs() <= 1e-6 * mass).all())
    assert torch.equal(planes.grad, expand.fused_expand_lanes_backward(cot, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.BACKWARD_INDEX_NAMES)
@pytest.mark.parametrize("n_tiles", ["T-1", "T", "T+1", "5T+3"])
def test_expand_backward_kernel_on_synthetic_indices(cuda, n_tiles, name):
    """The backward kernel on monotone indices built directly
    (``chip_smoke.backward_indices``): runs and gaps at its tile edges, n
    around one tile; d = 1 and 2. The same bits at two launches, each source
    within 1e-6 of its run's sum of |g| of a float64 scatter-add."""
    tile = chip_smoke.K1T_TILE
    n = {"T-1": tile - 1, "T": tile, "T+1": tile + 1, "5T+3": 5 * tile + 3}[n_tiles]
    idx = torch.from_numpy(chip_smoke.backward_indices(n, name, tile)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    for d in (1, 2):
        cot = torch.randn(d, n, generator=g, device=cuda)
        a, b = expand.fused_expand_backward(cot, idx), expand.fused_expand_backward(cot, idx)
        assert torch.equal(a, b)
        ref, mass = _float64_scatter(cot, idx)
        assert bool(((a.double() - ref).abs() <= 1e-6 * mass).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 5])
@pytest.mark.parametrize("n,n_lanes", [(400, 9), (65, 7), (1, 1), (2, 9), (6080, 9), (6081, 7), (7105, 1)])
def test_expand_lanes_backward_kernel_on_synthetic_indices(cuda, n, n_lanes, shift):
    """The lane backward kernel on columns built directly
    (``chip_smoke.backward_lane_indices``: each lane one of the kinds above,
    its tile the kernel's rows a chunk), below and past the rows it stages;
    d = 1, 2 and 5 (two plane groups). The same bits at two launches, within
    1e-6 of each source's run's sum of |g|."""
    idx = torch.from_numpy(chip_smoke.backward_lane_indices(n, n_lanes, shift)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(n + n_lanes + shift)
    for d in (1, 2, 5):
        cot = torch.randn(d, n, n_lanes, generator=g, device=cuda)
        a, b = expand.fused_expand_lanes_backward(cot, idx), expand.fused_expand_lanes_backward(cot, idx)
        assert torch.equal(a, b)
        ref, mass = _float64_scatter(cot, idx)
        assert bool(((a.double() - ref).abs() <= 1e-6 * mass).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [(), (4,)])
def test_differentiable_sisr_step_on_card_carries_the_gradient(cuda, lanes):
    """A differentiable SISR step on the card resamples through the kernel,
    its gathered values carry a ``grad_fn``, and the log-likelihood's
    gradient reaches the parameter through the backward kernel."""
    beta = torch.full(lanes, 0.6, device=cuda, requires_grad=True)
    model = pt.timeseries.LinearStateSpaceModel(pt.timeseries.models.AR(0.0, beta, 0.5), (1.0, 0.3))
    filt = pt.SISR(model, 1000, ess_threshold=2.0, differentiable=True, batch_shape=lanes)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = filt.initialize(gen)
    state = filt.filter(gen, 0.3, state, first_step=True)
    state = filt.filter(gen, -0.1, state)
    pred = filt.predict(gen, state)
    assert pred.x.value.grad_fn is not None
    back = (expand.fused_expand_backward.launches, expand.fused_expand_lanes_backward.launches)
    res = filt.batch_filter(gen, [0.3, -0.1, 0.5, 0.2])
    res.log_likelihood.sum().backward()
    assert bool(torch.isfinite(beta.grad).all()) and bool((beta.grad != 0).all())
    now = (expand.fused_expand_backward.launches, expand.fused_expand_lanes_backward.launches)
    assert now[1 if lanes else 0] - back[1 if lanes else 0] == 3  # the first step's gathers hold no gradient


def test_gradient_entry_points_refuse_without_a_card(monkeypatch):
    """Without a card, the OU process, the nutria model and the fits through
    a filter on the default device raise unless given ``device="cpu"``."""
    from pyfilter_tpu_torch import inference as inf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = lambda ctx: pt.examples.nutria_builder(ctx, num_obs=5)  # noqa: E731
    for make in (
        lambda: pt.timeseries.models.OrnsteinUhlenbeck(0.5, 1.0, 0.1),
        lambda: pt.examples.nutria_model(),
        lambda: inf.fit_svi(build, [0.1] * 5, lambda b: pt.APF(b, 10), num_steps=1),
        lambda: inf.fit_mle(build, [0.1] * 5, lambda b: pt.APF(b, 10), num_steps=1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    res = inf.fit_svi(build, [0.1] * 5, lambda b: pt.APF(b, 10, device="cpu"), num_steps=1, num_elbo_samples=2)
    assert res.context.device.type == "cpu" and res.losses.shape == (1,)


def _counted(fn, kernel=expand.fused_expand):
    """``fn()``'s result and ``kernel``'s launches during it (the expand
    kernel's by default)."""
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    return out, kernel.launches - before


@pytest.mark.cuda
def test_paris_on_card_resamples_through_the_kernel(cuda):
    """PaRIS on the card: the estimate and statistics stay on the device,
    the expand kernel launches once per resample fire, and a bound below the
    transition density's maximum poisons the estimate with NaN."""
    from pyfilter_tpu_torch.filters.particle.smoothing import paris

    y, sm_mean, _ = chip_smoke.ar_paris_data(40)
    hidden = pt.timeseries.models.AR(chip_smoke.AR_ALPHA, chip_smoke.AR_BETA, chip_smoke.AR_SIGMA)
    model = pt.timeseries.LinearStateSpaceModel(hidden, (1.0, chip_smoke.AR_OBS_S))
    filt = pt.SISR(model, 20_000)
    (est, stats, res), launches = _counted(lambda: paris(filt, torch.Generator(device=cuda).manual_seed(0), y,
                                                          lambda xp, xc, t: xc))
    assert est.device.type == stats.device.type == res.log_likelihood.device.type == "cuda"
    assert launches == filt.n_resamples > 0
    assert abs(float(est) - sm_mean.sum()) < 0.6
    bad, _, _ = paris(filt, torch.Generator(device=cuda).manual_seed(1), y, lambda xp, xc, t: xc, log_density_sup=-5.0)
    assert torch.isnan(bad)


@pytest.mark.cuda
def test_online_score_and_streaming_fit_on_card(cuda):
    """The online score on the card within tests/test_score.py's tolerance of
    the float64 Kalman score, its resamples through the kernel; a short
    streaming fit keeps its path on the device."""
    y = chip_smoke.stream_data(torch, pt, 100, seed=0)
    ctx = chip_smoke.stream_context(torch, pt, "cuda", 0.5, 0.5)
    counted = chip_smoke.counted_sisr(pt)  # counts the fires of every rebuilt copy
    res, launches = _counted(lambda: pt.inference.online_score(
        lambda c: chip_smoke.stream_builder(pt, c), y, lambda b: counted(b, 5000),
        torch.Generator(device=cuda).manual_seed(2), context=ctx))
    assert res.score.device.type == "cuda" and res.stats.shape == (5000, 2)
    assert launches == counted.fires > 0
    exact = chip_smoke.kalman_score(y, 0.5, 0.5)
    assert all(abs(float(a) - b) <= 2.5 + 0.18 * abs(b) for a, b in zip(res.score.cpu(), exact)), (res.score, exact)

    fit = pt.inference.fit_mle_streaming(lambda c: chip_smoke.stream_builder(pt, c), y, lambda b: pt.SISR(b, 500),
                                         torch.Generator(device=cuda).manual_seed(3), window=25,
                                         context=chip_smoke.stream_context(torch, pt, "cuda", 0.3, 0.7))
    assert fit.theta_path.device.type == "cuda" and fit.theta_path.shape == (4, 2)
    assert bool(torch.isfinite(fit.window_log_likelihoods).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", chip_smoke.RESAMPLERS)
def test_explicit_resamplers_never_launch_the_kernel_on_card(cuda, scheme):
    """SISR given any other resampler runs it on the card and launches
    neither resample kernel, on one lane and on lanes."""
    model = chip_smoke.oracle_model(pt, "ar", "cuda")
    _, y = chip_smoke.oracle_data("ar")
    for lanes in ((), (16,)):
        filt = pt.SISR(model, 2000 if not lanes else 400, resampling_method=getattr(pt.resampling, scheme),
                       batch_shape=lanes)
        before = (expand.fused_expand.launches, expand.fused_expand_lanes.launches)
        res = filt.batch_filter(torch.Generator(device=cuda).manual_seed(0), y[:, 0])
        torch.cuda.synchronize()
        assert (expand.fused_expand.launches, expand.fused_expand_lanes.launches) == before
        assert filt.n_resamples > 0 and bool(torch.isfinite(res.log_likelihood).all())


@pytest.mark.cuda
def test_single_step_api_on_card(cuda):
    """``step`` equals ``filter`` and ``batch_filter_masked`` equals
    ``batch_filter`` of the first rows, bit for bit, on one seed."""
    from pyfilter_tpu_torch.filters.base import pad_observations

    model = chip_smoke.oracle_model(pt, "ar", "cuda")
    _, y = chip_smoke.oracle_data("ar")
    filt = pt.SISR(model, 4096)
    state = filt.initialize(torch.Generator(device=cuda).manual_seed(0))
    a = filt.step(torch.Generator(device=cuda).manual_seed(1), y[0, 0], state, first_step=True)
    b = filt.filter(torch.Generator(device=cuda).manual_seed(1), y[0, 0], state, first_step=True)
    assert torch.equal(a.x.value, b.x.value) and torch.equal(a.log_likelihood, b.log_likelihood)
    padded, n_valid = pad_observations(y[:37, 0])
    masked = filt.batch_filter_masked(torch.Generator(device=cuda).manual_seed(2), padded, n_valid)
    plain = filt.batch_filter(torch.Generator(device=cuda).manual_seed(2), y[:37, 0])
    assert torch.equal(masked.log_likelihood, plain.log_likelihood) and masked.step_log_likelihoods.shape == (64,)


def test_streaming_entry_points_refuse_without_a_card(monkeypatch):
    """Without a card the four models and the streaming entry points on the
    default device raise; with ``device="cpu"`` they run."""
    models = pt.timeseries.models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = lambda ctx: chip_smoke.stream_builder(pt, ctx)  # noqa: E731
    for make in (
        lambda: models.LocalLinearTrend(0.05, 0.02),
        lambda: models.TrendingOU(0.8, 1.0, 0.05, 0.1),
        lambda: models.UCSV(0.05),
        lambda: models.Cyclical(0.9, 0.5, 0.1),
        lambda: pt.inference.online_score(build, [0.1] * 5, lambda b: pt.SISR(b, 10)),
        lambda: pt.inference.fit_mle_streaming(build, [0.1] * 5, lambda b: pt.SISR(b, 10), window=5),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    res = pt.inference.fit_mle_streaming(build, [0.1] * 5, lambda b: pt.SISR(b, 10, device="cpu"), window=5)
    assert res.context.device.type == "cpu" and res.theta_path.shape == (1, 2)


#: (family, parameters, scipy law) of every sampler the distribution layer
#: gained, at tests/test_distributions.py's parameters
_SAMPLERS = [
    ("Beta", dict(concentration1=2.0, concentration0=3.0), ("beta", (2.0, 3.0), {})),
    ("StudentT", dict(df=6.0, loc=0.3, scale=1.5), ("t", (6.0,), dict(loc=0.3, scale=1.5))),
    ("Laplace", dict(loc=0.4, scale=1.3), ("laplace", (0.4, 1.3), {})),
    ("Weibull", dict(scale=2.0, concentration=1.5), ("weibull_min", (1.5,), dict(scale=2.0))),
    ("HalfNormal", dict(scale=1.4), ("halfnorm", (), dict(scale=1.4))),
    ("Gumbel", dict(loc=0.3, scale=1.2), ("gumbel_r", (0.3, 1.2), {})),
    ("Logistic", dict(loc=-0.5, scale=0.9), ("logistic", (-0.5, 0.9), {})),
    ("Chi2", dict(df=3.5), ("chi2", (3.5,), {})),
    ("TruncatedNormal", dict(loc=0.5, scale=2.0, low=-1.0, high=3.0), ("truncnorm", (-0.75, 1.25),
                                                                       dict(loc=0.5, scale=2.0))),
    ("TruncatedNormal", dict(loc=0.0, scale=1.0, low=5.0, high=math.inf), ("truncnorm", (5.0, math.inf), {})),
    ("Poisson", dict(rate=3.7), ("poisson", (3.7,), {})),
    ("Bernoulli", dict(probs=0.3), ("bernoulli", (0.3,), {})),
    ("Binomial", dict(total_count=12.0, probs=0.4), ("binom", (12, 0.4), {})),
    ("NegativeBinomial", dict(total_count=5.0, probs=0.35), ("nbinom", (5, 0.65), {})),
    ("Categorical", dict(probs=[0.2, 0.3, 0.5]), None),
    ("Cauchy", dict(loc=-0.2, scale=0.8), None),
    ("HalfCauchy", dict(scale=0.7), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,law", _SAMPLERS, ids=[f"{s[0]}-{i}" for i, s in enumerate(_SAMPLERS)])
def test_samplers_take_a_cuda_generator(cuda, name, params, law):
    """Each sampler draws on the card from a CUDA generator: 200,000 draws
    whose mean lies within 4 SEM (+1e-3) of the law's and whose variance
    lies within 5% of it (the Categorical's frequencies within 0.01; the
    Cauchy laws' medians, having no moments)."""
    import numpy as np
    from scipy import stats

    d = pt.convert.distribution_from_numpy(name, device="cuda", **{k: np.asarray(v, np.float32)
                                                                   for k, v in params.items()})
    x = d.sample(torch.Generator(device=cuda).manual_seed(3), (200_000,))
    assert x.device.type == "cuda"
    x = x.double().cpu().numpy()
    if name == "Categorical":
        np.testing.assert_allclose(np.bincount(x.astype(int), minlength=3) / len(x), params["probs"], atol=0.01)
        return
    if law is None:
        ref = stats.cauchy(-0.2, 0.8) if name == "Cauchy" else stats.halfcauchy(scale=0.7)
        np.testing.assert_allclose(np.median(x), ref.median(), rtol=0.02, atol=0.01)
        return
    family, args, kwargs = law
    ref = getattr(stats, family)(*args, **kwargs)
    assert abs(x.mean() - ref.mean()) < 4 * ref.std() / math.sqrt(len(x)) + 1e-3, (x.mean(), ref.mean())
    np.testing.assert_allclose(x.var(), ref.var(), rtol=0.05)


@pytest.mark.cuda
def test_tempered_smc_on_card_fires_the_lane_kernel(cuda):
    """A short TemperedSMC fit on the card (phase 15's width over 30
    observations): the ladder ends at 1, the lane kernel launches once per
    SISR lane step (the initial pass and two MH re-filters a stage), and the
    swarm lands in the context on the card."""
    y = chip_smoke.pmmh_data(torch, pt)[:30]
    counted = chip_smoke.counted_sisr(pt)
    (alg, res, _), launches = _counted(lambda: chip_smoke.zoo_tempered(torch, pt, y, "cuda", 1, counted=counted),
                                       expand.fused_expand_lanes)
    assert res.lambdas[-1] == 1.0 and all(b > a for a, b in zip(res.lambdas, res.lambdas[1:]))
    assert launches == counted.fires == (1 + 2 * len(res.lambdas)) * 30
    assert alg.context.get_parameter("beta").device.type == "cuda"
    assert all(math.isfinite(float(v.mean())) for v in res.samples.values())


@pytest.mark.cuda
def test_if2_and_predictive_diagnostics_on_card(cuda):
    """Two IF2 passes on the card launch the lane kernel once per lane step;
    PIT and CRPS of a recorded single-lane SISR run stay on the card and the
    expand kernel launches once per resample fire."""
    y = chip_smoke.pmmh_data(torch, pt)[:40]
    counted = chip_smoke.counted_sisr(pt)
    (alg, res, _), launches = _counted(lambda: chip_smoke.zoo_if2(torch, pt, y, "cuda", 2, counted=counted,
                                                                   iterations=2), expand.fused_expand_lanes)
    assert launches == counted.fires == 2 * 40 and res.log_likelihoods.shape == (2,)
    model = chip_smoke.zoo_fitted(pt, float(res.mle["beta"]), float(res.mle["sigma"]), "cuda")
    filt = counted(model, 300, record_states=True)
    counted.fires = 0
    before = expand.fused_expand.launches
    fres = filt.batch_filter(torch.Generator(device=cuda).manual_seed(3), y)
    torch.cuda.synchronize()
    assert expand.fused_expand.launches - before == counted.fires > 0
    u = pt.filters.predictive_pit(torch.Generator(device=cuda).manual_seed(4), model, fres, y)
    c = pt.filters.crps(torch.Generator(device=cuda).manual_seed(5), model, fres, y)
    assert u.device.type == c.device.type == "cuda" and u.shape == c.shape == (40,)
    assert bool(((u >= 0) & (u <= 1)).all()) and bool((c > 0).all())
