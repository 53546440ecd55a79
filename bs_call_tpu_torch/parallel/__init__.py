"""Runs of the caller across processes (`shard_runner`: `--shards N`)."""
