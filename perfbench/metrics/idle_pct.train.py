"""Share of the traced window in which no device operation ran."""

from perfbench.readers import idle_pct as read  # noqa: F401
