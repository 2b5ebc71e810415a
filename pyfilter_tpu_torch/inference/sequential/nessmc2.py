"""NESSMC2 and SMC2FW: SMC² first, then online jittering.

Counterpart of ``pyfilter_tpu/inference/sequential/nessmc2.py``.
"""

from __future__ import annotations

from typing import Any, Dict

from .base import CombinedSequentialParticleAlgorithm
from .kernels import ShrinkingKernel
from .ness import NESS, FixedWidthNESS
from .smc2 import SMC2


class NESSMC2(CombinedSequentialParticleAlgorithm):
    """SMC² (threshold 0.5) up to observation ``switch``, then NESS with the
    shrinking kernel and threshold 0.95, as the NESS article recommends."""

    def __init__(
        self,
        filter_,
        particles: int,
        switch: int = 500,
        smc2_kw: Dict[str, Any] = None,
        ness_kw: Dict[str, Any] = None,
        context=None,
        generator=None,
        **kwargs,
    ):
        super().__init__(filter_, particles, switch, first_kw=smc2_kw, second_kw=ness_kw, context=context,
                         generator=generator, **kwargs)

    def make_first(self, filter_, context, particles, **kwargs):
        threshold = kwargs.pop("threshold", 0.5)
        return SMC2(filter_, particles, threshold=threshold, context=context, **kwargs)

    def make_second(self, filter_, context, particles, **kwargs):
        kernel = kwargs.pop("kernel", ShrinkingKernel())
        return NESS(filter_, particles, kernel=kernel, threshold=kwargs.pop("threshold", 0.95), context=context,
                    **kwargs)

    def do_on_switch(self, first, second, state):
        return state


class SMC2FW(NESSMC2):
    """SMC² then FixedWidthNESS (Jasra and Zhou)."""

    def make_second(self, filter_, context, particles, **kwargs):
        return FixedWidthNESS(filter_, particles, context=context, **kwargs)
