"""idle_pct.exact_gp (%): the share of the window of a ``fit_exact_gp`` cell in
which no operation ran on the device."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
