"""Metrics (the port of ``fengshen_tpu/metrics``): ROUGE so far."""

from fengshen_tpu_torch.metrics.rouge import rouge_scores

__all__ = ["rouge_scores"]
