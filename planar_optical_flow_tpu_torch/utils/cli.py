"""Small helpers shared by the port's CLIs."""

from __future__ import annotations


def parse_batches(parser, raw) -> list[int]:
    """Parse a ``--batch`` value (an int or a comma list) with readable
    errors, before any model is built, so that a typo fails at once
    (``cli.export_serving``, ``cli.export_model``)."""
    try:
        batches = [int(b) for b in str(raw).split(",") if b.strip()]
    except ValueError:
        parser.error(
            f"--batch must be an int or comma list of ints, got {raw!r}")
    if not batches or any(b < 1 for b in batches):
        parser.error(f"--batch sizes must be >= 1, got {raw!r}")
    if len(set(batches)) != len(batches):
        parser.error(f"--batch has duplicate sizes: {raw!r}")
    return batches
