"""The deterministic fixture's reference with no checks of its own, so
that compare.checks judges it."""
from .fixture_exact import expected  # noqa: F401
