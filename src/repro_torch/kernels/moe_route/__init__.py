from .ops import (MAX_EXPERTS, MAX_ROUNDS, THREADS, WARPS, route_grid, route_slots,
                  route_slots_cuda, route_slots_path, route_slots_plain)

__all__ = ["MAX_EXPERTS", "MAX_ROUNDS", "THREADS", "WARPS", "route_grid", "route_slots",
           "route_slots_cuda", "route_slots_path", "route_slots_plain"]
