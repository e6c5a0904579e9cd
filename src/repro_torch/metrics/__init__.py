from repro_torch.metrics.logging import CSVLogger, MeterRegistry  # noqa: F401
