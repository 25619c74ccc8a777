"""Recording rules & alerting: the in-process continuous-query engine (the
counterpart of ``filodb_tpu.rules``).

``loader`` parses Prometheus-style rule files, ``engine`` schedules and
evaluates them as standing queries through the normal serving path,
``notify`` delivers alert webhooks through the resilience stack, and
``python -m filodb_tpu_torch.rules --check <file>`` validates a rule file
promtool-style.
"""

from filodb_tpu_torch.rules.engine import (RULES_DATASET, RulesEngine,
                                           STATE_FIRING, STATE_INACTIVE,
                                           STATE_PENDING)
from filodb_tpu_torch.rules.loader import (Rule, RuleGroup, RuleLoadError,
                                           check_rules_file, load_groups,
                                           load_rules_file, parse_rules_text)
from filodb_tpu_torch.rules.notify import WebhookNotifier

__all__ = [
    "RULES_DATASET", "RulesEngine", "STATE_FIRING", "STATE_INACTIVE",
    "STATE_PENDING", "Rule", "RuleGroup", "RuleLoadError",
    "check_rules_file", "load_groups", "load_rules_file",
    "parse_rules_text", "WebhookNotifier",
]
