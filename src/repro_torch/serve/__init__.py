"""Serving on the port: the micro-batch executor (``batching``) that runs a
batch of compatible requests on one warm solver."""
from repro_torch.serve.batching import (execute_batch, occur_fastpath_eligible,
                                        stacked_eligible)

__all__ = ["execute_batch", "occur_fastpath_eligible", "stacked_eligible"]
