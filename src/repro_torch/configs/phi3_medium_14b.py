# Copied unchanged from src/repro/configs/phi3_medium_14b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import PHI3_MEDIUM as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
