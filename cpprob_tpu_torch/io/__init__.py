"""I/O (counterpart of ``cpprob_tpu/io``): the reference's text
serialization and posterior dumps, and the offline trace shards
(``io/tracefile.py``)."""

from .serialization import (
    dump_posterior,
    dump_posterior_npz,
    format_value,
    load_posterior,
    load_posterior_npz,
    parse_observes,
    parse_value,
)

__all__ = [
    "parse_value",
    "parse_observes",
    "format_value",
    "dump_posterior",
    "load_posterior",
    "dump_posterior_npz",
    "load_posterior_npz",
]
