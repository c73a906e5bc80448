"""As `flash_prefill_roofline`, in the cell above the knee, where it moves the tokens
completed per second."""
from pathlib import Path

from bench.cell import load_module

read = load_module(Path(__file__).with_name("flash_prefill_roofline.py")).read
