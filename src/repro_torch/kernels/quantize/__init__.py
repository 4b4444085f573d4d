from repro_torch.kernels.quantize.ref import (QDTYPES, QMAX, SCALE_EPS,
                                              quantize_axis, target_dtype)

__all__ = ["QDTYPES", "QMAX", "SCALE_EPS", "quantize_axis", "target_dtype"]
