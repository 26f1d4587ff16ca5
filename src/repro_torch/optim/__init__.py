"""AdamW with global-norm clipping and the cosine learning-rate schedule,
over nested dicts of tensors (the LM scaffold's parameter trees)."""
from .adamw import adamw_init, adamw_update, global_norm, clip_by_global_norm
from .schedule import cosine_schedule
