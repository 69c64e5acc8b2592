"""idle_pct.updates (%): the share of the window of a ``train_pls`` cell in
which no operation ran on the device."""

from benchmark.harness.readers import idle_pct as read  # noqa: F401
