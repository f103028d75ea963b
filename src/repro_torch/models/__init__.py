from repro_torch.models.lm import (RunOptions, cache_spec, compute_logits,
                                   decode_step, forward_hidden, init_cache,
                                   init_params, model_spec, param_count,
                                   prefill)

__all__ = ["RunOptions", "cache_spec", "compute_logits", "decode_step",
           "forward_hidden", "init_cache", "init_params", "model_spec",
           "param_count", "prefill"]
