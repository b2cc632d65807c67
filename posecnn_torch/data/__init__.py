"""The port's data path: synthetic scenes, dataset readers, minibatches,
the prefetching feed and the offline shard store."""

from posecnn_torch.data.shards import ShardReader, write_shards

__all__ = ["ShardReader", "write_shards"]
