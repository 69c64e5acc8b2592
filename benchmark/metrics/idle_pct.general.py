"""idle_pct.general (%): the share of the window of a ``general_fused`` cell
in which no operation ran on the device."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
