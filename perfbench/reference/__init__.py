"""The plain float32 reference the benchmark holds the port to; it imports nothing of the port."""
