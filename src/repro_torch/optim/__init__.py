"""AdamW and the train step (counterpart of `repro.optim`)."""
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule, make_train_step

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "make_train_step"]
