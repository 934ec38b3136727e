"""Distribution: ``DistCtx`` over a ``DeviceMesh`` and local-shard regions."""
