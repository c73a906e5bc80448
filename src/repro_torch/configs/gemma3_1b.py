# Copied unchanged from src/repro/configs/gemma3_1b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import GEMMA3_1B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
