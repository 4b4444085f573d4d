from repro_torch.evals.core_eval import heldout_metrics
from repro_torch.evals.tasks import (arith_exact, chat_suite, mc_accuracy,
                                     pattern_exact)

__all__ = ["heldout_metrics", "mc_accuracy", "arith_exact", "pattern_exact",
           "chat_suite"]
