from repro_torch.models.transformer import (decode_step_lm,
                                            decode_step_paged,
                                            forward_hidden, forward_lm,
                                            init_decode_cache,
                                            init_paged_cache, init_params,
                                            lm_loss, paged_block_bytes,
                                            paged_cache_supported,
                                            param_names, param_shapes,
                                            verify_step_paged)

__all__ = ["decode_step_lm", "decode_step_paged", "forward_hidden",
           "forward_lm", "init_decode_cache", "init_paged_cache",
           "init_params", "lm_loss", "paged_block_bytes",
           "paged_cache_supported", "param_names", "param_shapes",
           "verify_step_paged"]
