from .ranks import (RayGroup, RayShard, check_batch, group, group_for, init_rank, run_cli,
                    shutdown, spawn)

__all__ = ["RayGroup", "RayShard", "check_batch", "group", "group_for", "init_rank", "run_cli",
           "shutdown", "spawn"]
