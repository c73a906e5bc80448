# Copied unchanged from src/repro/configs/mixtral_8x22b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import MIXTRAL_8X22B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
