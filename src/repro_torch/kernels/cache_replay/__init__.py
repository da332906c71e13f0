"""Set-parallel LRU write-back cache replay (the cache backend's hot loop).

``kernel.py`` holds the wrapper of the hand-written CUDA kernels
(``csrc/cache_replay.cu``), their plain PyTorch version and the launch
count; ``ops.py`` the public entry point that partitions a stream by set
and puts the per-access results back into stream order.
"""

from repro_torch.kernels.cache_replay.kernel import (MAX_WAYS,
                                                     cache_replay_plain,
                                                     cache_replay_sorted)
from repro_torch.kernels.cache_replay.ops import (cache_replay,
                                                  decode,
                                                  partition_by_set)

__all__ = ["MAX_WAYS", "cache_replay", "cache_replay_plain",
           "cache_replay_sorted", "decode", "partition_by_set"]
