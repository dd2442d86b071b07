"""The model families (dense, MoE, vlm, ssm, the recurrent hybrid, audio):
the model functions, the training forward, the decode steps and the
operator-segmented prefill."""
from repro_torch.models.model import (REMAT_POLICIES, cache_shapes,
                                      decode_step, forward, model_shapes,
                                      prefill)

__all__ = ["REMAT_POLICIES", "cache_shapes", "decode_step", "forward",
           "model_shapes", "prefill"]
