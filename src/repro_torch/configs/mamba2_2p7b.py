# Copied unchanged from src/repro/configs/mamba2_2p7b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import MAMBA2_2P7B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
