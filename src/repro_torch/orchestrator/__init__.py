"""The paper's scheduler driving real training (counterpart of
`repro.orchestrator`)."""
from repro_torch.orchestrator.green import Cloud, GreenOrchestrator, TrainJob

__all__ = ["Cloud", "GreenOrchestrator", "TrainJob"]
