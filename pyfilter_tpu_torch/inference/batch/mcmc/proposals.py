"""MCMC proposal builders for PMMH updates: ``BaseProposal`` and
``SymmetricMH``.

Counterpart of ``pyfilter_tpu/inference/batch/mcmc/proposals.py`` (the SMC²
proposal; the others come later). Kernels live on the unconstrained
parameter space.
"""

from __future__ import annotations

from ...utils import construct_mvn


class BaseProposal:
    """Builds candidate kernels :math:`q(\\theta^* | \\theta)`."""

    def build(self, context, state, filter_, y):
        raise NotImplementedError


class SymmetricMH(BaseProposal):
    """The weighted parameter cloud's MVN with its Cholesky factor scaled by
    1.1: SMC²'s rejuvenation proposal."""

    def build(self, context, state, filter_, y):
        return construct_mvn(context.stack_parameters(constrained=False), state.normalized_weights(), scale=1.1)
