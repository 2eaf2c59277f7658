"""Cross-plane observability: the flight recorder (:mod:`.flight`).

Deliberately empty of imports: ``common/metrics.py`` and
``common/tracing.py`` import ``tez_tpu_torch.obs.flight`` on their hot
paths, so this package must never pull in modules that import them back.
"""
