# Copied unchanged from src/repro/configs/zamba2_7b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import ZAMBA2_7B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
