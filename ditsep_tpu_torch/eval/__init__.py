"""Evaluation: metrics and the bucketed batched eval harness."""
from ditsep_tpu_torch.eval.evaluate import evaluate_dataset  # noqa: F401
from ditsep_tpu_torch.eval.metrics import (  # noqa: F401
    compute_metrics,
    pesq_metric,
    si_bss_eval_sources,
    stoi,
)
