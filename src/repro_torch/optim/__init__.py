from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                    opt_state_bytes)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm",
           "opt_state_bytes", "cosine_schedule"]
