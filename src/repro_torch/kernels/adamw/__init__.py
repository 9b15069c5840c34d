from .ops import (CHUNK, MAX_LEAVES, Plan, Prepared, adamw_update_cuda, device_plan,
                  global_norm_cuda, leaf_tables, local, plan, prepare, refusal)

__all__ = ["CHUNK", "MAX_LEAVES", "Plan", "Prepared", "adamw_update_cuda", "device_plan",
           "global_norm_cuda", "leaf_tables", "local", "plan", "prepare", "refusal"]
