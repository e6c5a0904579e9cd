"""The harness of the port's benchmark: traffic, weights, the cells, the trace and the yardstick."""
