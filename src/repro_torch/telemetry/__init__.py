from repro_torch.telemetry.profile import PHASES, phase

__all__ = ["PHASES", "phase"]
