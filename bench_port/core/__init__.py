"""The harness: the cell's files, the traffic generator, the weights,
the drivers of the port, the trace reduction and the check."""
