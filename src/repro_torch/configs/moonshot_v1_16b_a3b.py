# Copied unchanged from src/repro/configs/moonshot_v1_16b_a3b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import MOONSHOT_16B_A3B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
