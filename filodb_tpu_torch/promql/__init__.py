"""PromQL frontend: parser producing LogicalPlans (copy of
``filodb_tpu.promql.parser``)."""

from filodb_tpu_torch.promql.parser import parse_query, parse_query_range  # noqa: F401
