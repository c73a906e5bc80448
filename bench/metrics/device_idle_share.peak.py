"""As `device_idle_share`, in the cell above the knee, where it moves the tokens
completed per second."""
from pathlib import Path

from bench.cell import load_module

read = load_module(Path(__file__).with_name("device_idle_share.py")).read
