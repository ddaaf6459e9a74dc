from repro_torch.serve.loop import (
    ServeExporter,
    ServeReport,
    latency_percentiles,
    make_serve_step,
    serve_loop,
)

__all__ = ["ServeExporter", "ServeReport", "latency_percentiles", "make_serve_step", "serve_loop"]
