# Copied unchanged from src/repro/configs/internvl2_76b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import INTERNVL2_76B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
