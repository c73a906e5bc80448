# Copied unchanged from src/repro/configs/seamless_m4t_large_v2.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import SEAMLESS_M4T_V2 as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
