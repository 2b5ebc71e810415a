"""The port's CUDA kernels on the card (marker ``cuda``; skips without a GPU).

This file imports only torch and the port, so it also runs where JAX is not
installed (skip the JAX-side conftest there):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 4099, 1_000_003])
@pytest.mark.parametrize("d", [1, 3])
def test_expand_kernel_matches_plain_on_card(cuda, n, d):
    """Bit for bit against the plain version, on random, degenerate and
    zero-run weights, with a random u and with u == 1.0."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    v2d = torch.randn(d, n, generator=g, device=cuda)
    hot = torch.full((n,), -math.inf, device=cuda)
    hot[n // 2] = 0.0
    zero_runs = torch.where(torch.arange(n, device=cuda) % 3 == 0, 0.0, -math.inf)
    for lw in (torch.randn(n, generator=g, device=cuda) * 2.0, hot, zero_runs):
        for u in (0.37, 1.0):
            counts = expand._counts_from_probs(torch.softmax(lw, 0), torch.tensor(u, device=cuda))
            before = expand.fused_expand.launches
            out, idx = expand.fused_expand(counts, v2d)
            ref_out, ref_idx = expand._expand_plain(counts, v2d)
            torch.cuda.synchronize()
            assert expand.fused_expand.launches == before + 1
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
    (first, middle, last by ``n``), lane 1 alternating zero-weight runs."""
    lw = torch.randn(n, n_lanes, generator=g, device=dev) * scale
    lw[:, 0] = -math.inf
    lw[(0, n // 2, n - 1)[n % 3], 0] = 0.0
    if n_lanes > 1:
        lw[:, 1] = torch.where(torch.arange(n, device=dev) % 3 == 0, 0.0, -math.inf)
    return lw


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_lanes", [(400, 100), (257, 5), (40, 16), (72, 16), (800, 64), (3200, 33)])
@pytest.mark.parametrize("d", [1, 2])
def test_expand_lanes_kernel_matches_plain_on_card(cuda, n, n_lanes, d):
    """Bit for bit against the plain version: weight scales 1 and 6, a
    degenerate lane, zero-weight runs, random uniforms and ``u == 1.0``."""
    g = torch.Generator(device=cuda).manual_seed(n + n_lanes + d)
    planes = torch.randn(d, n, n_lanes, generator=g, device=cuda)
    for scale in (1.0, 6.0):
        probs = torch.softmax(_lane_weights(n, n_lanes, scale, g, cuda), dim=0)
        for u in (torch.rand(n_lanes, generator=g, device=cuda), torch.ones(n_lanes, device=cuda)):
            counts = expand._lane_counts_from_probs(probs, u)
            before = expand.fused_expand_lanes.launches
            out, idx = expand.fused_expand_lanes(counts, planes)
            ref_out, ref_idx = expand._expand_lanes_plain(counts, planes)
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
