"""The model families (dense, uniform MoE, ssm, the recurrent hybrid): the
model functions, the decode steps and the operator-segmented prefill."""
from repro_torch.models.model import (cache_shapes, decode_step, init_cache,
                                      model_shapes, prefill)

__all__ = ["cache_shapes", "decode_step", "init_cache", "model_shapes",
           "prefill"]
