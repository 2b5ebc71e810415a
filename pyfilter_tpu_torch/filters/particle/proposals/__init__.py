"""Proposal distributions (the bootstrap proposal of the main path)."""

from .base import Proposal
from .bootstrap import Bootstrap

__all__ = ["Proposal", "Bootstrap"]
