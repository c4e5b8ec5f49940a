"""Corpus sharding over several devices and processes (ports
``coregex_tpu/parallel/``): ``shard`` (the two-phase exact scan over a
mesh of torch devices), ``sharded_count`` (the count transducer over it)
and ``distributed`` (several processes over torch.distributed)."""
