"""Tools that set the benchmark's yardstick: the readings behind the
check's limits, and the open loop's rate sweep."""
