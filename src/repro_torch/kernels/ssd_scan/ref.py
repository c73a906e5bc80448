"""Plain PyTorch version of the SSD scan (port of
`repro/kernels/ssd_scan/ref.py`): it delegates to the model-side chunked
implementation, itself held against the sequential recurrence."""
from __future__ import annotations

from ...models import ssd as _ssd


def ssd_scan_ref(x, dt, A, B, C, D, *, chunk: int = 128, h0=None):
    return _ssd.ssd_chunked(x, dt, A, B, C, D, chunk, h0=h0)


def ssd_scan_sequential(x, dt, A, B, C, D, h0=None):
    return _ssd.ssd_reference(x, dt, A, B, C, D, h0=h0)
