# Copied unchanged from src/repro/configs/yi_6b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import YI_6B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
