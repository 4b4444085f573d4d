from repro_torch.models.transformer import (decode_step_paged,
                                            init_paged_cache, init_params,
                                            paged_block_bytes,
                                            paged_cache_supported,
                                            param_shapes, verify_step_paged)

__all__ = ["decode_step_paged", "init_paged_cache", "init_params",
           "paged_block_bytes", "paged_cache_supported", "param_shapes",
           "verify_step_paged"]
