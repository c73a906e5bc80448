"""Prompt tokens prefilled plus output tokens generated in the window,
over the window's virtual seconds (a prompt counts when its first token
lands)."""
from bench.reduce import tokens_in_window


def read(run):
    span = run.w1 - run.w0
    return sum(tokens_in_window(run)) / span if span > 0 else None
