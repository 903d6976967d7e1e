"""Multi-GPU over ``torch.distributed`` (counterpart of
``quest_tpu/parallel``): the ``(dp, tp)`` mesh and sharding rules, the
tensor- and data-parallel steps, and the multi-host launch."""

from quest_tpu_torch.parallel.mesh import (DP_AXIS, TP_AXIS, cache_specs,
                                           make_mesh, param_specs,
                                           shard_params)
from quest_tpu_torch.parallel.multihost import (global_batch,
                                                host_local_logits,
                                                initialize_cluster,
                                                make_global_mesh)
from quest_tpu_torch.parallel.tp import (init_sharded_cache, local_config,
                                         make_serving_fns, make_sharded_fns)

__all__ = ["DP_AXIS", "TP_AXIS", "cache_specs", "make_mesh", "param_specs",
           "shard_params", "init_sharded_cache", "local_config",
           "make_sharded_fns", "make_serving_fns", "initialize_cluster",
           "make_global_mesh", "global_batch", "host_local_logits"]
