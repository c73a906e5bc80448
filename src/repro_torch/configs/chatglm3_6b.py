# Copied unchanged from src/repro/configs/chatglm3_6b.py.
"""Assigned architecture config (see archs.py for the literal)."""
from .archs import CHATGLM3_6B as CONFIG
from .archs import smoke

SMOKE = smoke(CONFIG)
