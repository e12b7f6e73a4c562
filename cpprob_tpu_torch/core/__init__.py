"""The trace substrate: effect handlers, the primitive statements and
``scan_sites`` (counterpart of ``cpprob_tpu/core``).  ``as_tensor`` puts a
model's numbers and host arrays on the running ``Seed``'s device."""

from . import handlers
from .handlers import as_tensor
from .scanner import SiteIndex, scan_sites
from .primitives import (
    factor,
    metaobserve,
    observe,
    predict,
    guarded_rejection,
    rejection_sample,
    rejection_sampling,
    sample,
)

__all__ = [
    "handlers",
    "sample",
    "observe",
    "predict",
    "factor",
    "metaobserve",
    "rejection_sampling",
    "guarded_rejection",
    "rejection_sample",
    "scan_sites",
    "SiteIndex",
]
