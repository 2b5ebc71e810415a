"""The port against the exact float64 Kalman oracle on the ``"joint2d"``
model: the nine filters of the JAX package's ``test_filter_vs_kalman_2d``
at N = 1500, T = 100 (``test_torch_port_oracle.py`` holds the suite's
data, gates and the AR model)."""

import pytest

import test_torch_port_oracle as oracle


@pytest.mark.parametrize("filter_name", oracle.FILTERS_2D)
def test_filter_vs_kalman_joint2d(filter_name):
    filt, result, _ = oracle.run_filter_check("joint2d", filter_name)
    if filter_name.startswith("gpf"):
        assert filt.n_resamples == 0
