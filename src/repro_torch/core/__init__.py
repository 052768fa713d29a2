"""Distributed-memory CNN primitives (paper §III): the halo exchange, the
spatially decomposed conv, pooling and BN over `torch.distributed`."""
