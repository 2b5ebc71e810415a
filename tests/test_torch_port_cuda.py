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
