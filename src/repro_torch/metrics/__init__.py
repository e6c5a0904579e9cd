from repro_torch.metrics.logging import CSVLogger, MeterRegistry, comm_report  # noqa: F401
