"""The LM's mesh layout on ``torch.distributed`` (port of
``repro/distributed``): sharding rules, the tensor-parallel step's
collectives, elastic re-shard and the int8 compressed all-reduce."""
