"""idle_pct.svgp (%): the share of the window of a ``fit_svgp`` cell in
which no operation ran on the device."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
